"""Chunked and streamed execution over grid columns, and data parallelism
over a mesh of devices, with the helpers that join several processes."""

from .chunked import chunked, pad_fill, scan_map
from .mesh import (Mesh, Replicated, Sharded, batch_spec, distributed_init,
                   global_stats, make_mesh, pad_batch, replicate, replicated,
                   shard_batch, sharded_map)
from .stream import stream_map

__all__ = ['Mesh', 'Replicated', 'Sharded', 'batch_spec', 'chunked',
           'distributed_init', 'global_stats', 'make_mesh', 'pad_batch',
           'pad_fill', 'replicate', 'replicated', 'scan_map', 'shard_batch',
           'sharded_map', 'stream_map']
