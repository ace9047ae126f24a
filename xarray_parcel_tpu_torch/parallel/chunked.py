"""Device-resident chunked execution: a loop over fixed-size column chunks.

Port of ``xarray_parcel_tpu.parallel.chunked``.  ``stream_map`` (the
out-of-core path) streams host chunks through the device; this module is
its on-device complement: the whole batch is already resident, and the
column program runs on it chunk by chunk, so that its intermediates are
chunk-sized.  The modular pipeline's working set is some 20 KB a column,
so a batch that does not fit whole runs in chunks that do.  The JAX
package sequences the chunks with ``lax.map`` inside one compiled program;
eager torch needs no program, so here it is a plain Python loop, with the
same numerics as calling the program per chunk and concatenating.
Under ``torch.profiler`` each chunk's slicing and padding is the span
``xparcel.chunked.slice``, and the slicing off of the padding and the
final concatenation are ``xparcel.chunked.gather``; the column program
runs outside both.
"""

import numpy as np
import torch

from .._build import count, span


def pad_fill(dtype, float_fill=np.nan):
    """The batch-padding value: ``float_fill`` (NaN, which the pipelines
    turn into NaN outputs) for floats, zero for ints and bools.  Padded
    rows are sliced off.  ``dtype`` is a numpy or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return float_fill if dtype.is_floating_point else 0
    dtype = np.dtype(dtype)
    return (float_fill if np.issubdtype(dtype, np.floating)
            else np.zeros((), dtype).item())


def _pad_rows(x, rows):
    """``x`` with ``rows`` more leading rows of :func:`pad_fill`."""
    pad = x.new_full((rows,) + x.shape[1:], pad_fill(x.dtype))
    return torch.cat([x, pad])


def _map_leaves(fn, tree):
    """``fn`` over the tensors of a (nested) dict/list/tuple."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    """The leaves of a (nested) dict/list/tuple, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def _zip_leaves(fn, trees):
    """``fn`` over the lists of corresponding tensors of same-shaped
    trees."""
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, _zip_leaves(fn, [t[k] for t in trees]))
                           for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_leaves(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(trees)


def chunked(fn, chunk_columns=1 << 18):
    """Wrap a dict -> tree column program so that it runs in fixed-size
    column chunks: a chunk-bounded working set at any batch size.

    ``fn`` takes a dict of tensors with a shared leading batch dim (level
    fields (B, L), surface fields (B,)) and returns a dict, list or tuple
    (nested at will) of tensors with the same leading dim.  The wrapper
    pads the last chunk up to ``chunk_columns`` (NaN for floats, zero for
    ints and bools; padded rows are sliced off the outputs), so ``fn``
    only ever sees one shape.

    Numerics are identical to running ``fn`` on each padded chunk and
    concatenating.  The wrapper counts, over all its calls, the chunks it
    ran (``.chunks``) and the padding rows computed (``.padded_rows``).
    """
    def wrapped(dat):
        if not dat:
            raise ValueError('empty input dict: nothing to chunk')
        if any(x.dim() == 0 for x in dat.values()):
            raise ValueError('inputs must carry a leading batch dim; '
                             'got a 0-d tensor')
        sizes = {x.shape[0] for x in dat.values()}
        if len(sizes) != 1:
            raise ValueError(f'mixed leading batch dims: {sorted(sizes)}')
        B = sizes.pop()
        C = max(1, min(int(chunk_columns), B))
        outs = []
        for start in range(0, max(B, 1), C):
            with span('xparcel.chunked.slice'):
                chunk = {k: v[start:start + C] for k, v in dat.items()}
                rows = min(C, B - start)
                if rows < C:
                    chunk = {k: _pad_rows(v, C - rows)
                             for k, v in chunk.items()}
            outs.append(fn(chunk))
            count(wrapped, 'chunks')
            count(wrapped, 'padded_rows', C - rows)
        with span('xparcel.chunked.gather'):
            if rows < C:            # only the last chunk is padded
                outs[-1] = _map_leaves(lambda y: y[:rows], outs[-1])
            return _zip_leaves(torch.cat, outs)

    wrapped.chunks = 0
    wrapped.padded_rows = 0
    return wrapped


def scan_map(fn, dat, chunk_columns=1 << 18):
    """One-shot form: ``chunked(fn, chunk_columns)(dat)``."""
    return chunked(fn, chunk_columns)(dat)
