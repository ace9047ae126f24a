"""Utilities: tolerance comparison of result sets."""

from .compare import compare, compare_archives, compare_results

__all__ = ['compare', 'compare_archives', 'compare_results']
