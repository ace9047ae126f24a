"""Chunked and streamed execution over grid columns on one device."""

from .chunked import chunked, pad_fill, scan_map
from .stream import stream_map

__all__ = ['chunked', 'pad_fill', 'scan_map', 'stream_map']
