"""Utilities: profiling/timing instrumentation and tolerance comparison."""

from .compare import compare, compare_archives, compare_results
from .profiling import (Timer, columns_per_second, infer_columns, span,
                        time_function, trace)

__all__ = ['Timer', 'columns_per_second', 'compare', 'compare_archives',
           'compare_results', 'infer_columns', 'span', 'time_function',
           'trace']
