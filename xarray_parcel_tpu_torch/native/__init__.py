"""Host-side ingest helpers on numpy arrays.

The port's own copy of the numpy definitions of ``xarray_parcel_tpu.native``:
column validation, the float32 repack, the level-axis move of the Dataset
ingest, and a host-side left-compaction.  The JAX package also has a C++
fast path for them (``ingest.cc``); the port has the numpy form only.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# levels_to_last splits arrays of at least this many elements over threads.
_THREADED_FROM = 1 << 22
_THREADS = min(8, os.cpu_count() or 1)


def validate_columns(pressure):
    """Per-column validity of the reference's input invariant: pressure
    strictly decreasing along the trailing axis, NaN padding only at the
    top.  Returns a boolean array over the batch dims."""
    p = np.ascontiguousarray(pressure)
    batch = p.shape[:-1]
    flat = p.reshape(-1, p.shape[-1])
    nan = np.isnan(flat)
    with np.errstate(invalid='ignore'):
        decreasing = np.where(nan[:, 1:] | nan[:, :-1], True,
                              np.diff(flat, axis=-1) < 0)
    # A finite pressure after a NaN one is malformed.
    resurrect = ~nan[:, 1:] & nan[:, :-1]
    return (decreasing.all(-1) & ~resurrect.any(-1)).reshape(batch)


def repack_to_f32(arr):
    """``arr`` as a contiguous float32 array of the same shape (itself if
    it already is one)."""
    a = np.asarray(arr)
    if a.dtype == np.float32 and a.flags.c_contiguous:
        return a
    # (ascontiguousarray alone would make a 0-d array 1-d.)
    return np.ascontiguousarray(a, np.float32).reshape(a.shape)


def levels_to_last(arr):
    """Move a leading level axis to the trailing position, (L, …) -> (…, L),
    converting to contiguous float32: the Dataset ingest's repack."""
    a = np.asarray(arr)
    out = np.empty(a.shape[1:] + a.shape[:1], np.float32)
    if a.size < _THREADED_FROM or not a.flags.c_contiguous:
        out[...] = np.moveaxis(a, 0, -1)
        return out
    # A large grid: the strided copy is memory-latency bound on one core and
    # numpy releases the GIL in it, so column blocks go to a few threads.
    src = a.reshape(a.shape[0], -1)
    dst = out.reshape(-1, a.shape[0])
    step = -(-src.shape[1] // _THREADS)

    def move(start):
        dst[start:start + step] = src[:, start:start + step].T

    with ThreadPoolExecutor(_THREADS) as pool:
        list(pool.map(move, range(0, src.shape[1], step)))
    return out


def compact_left(fields, key):
    """Host-side left-compaction of leading NaNs (in the ``key`` field's NaN
    pattern) across a dict of (…, L) float arrays.  Float dtypes are kept;
    other dtypes are cast to float32 so the NaN fill is representable.
    Returns new arrays.  Device-side equivalent: ``ops.compact_left``."""
    def as_float(v):
        a = np.ascontiguousarray(v)
        return (a if np.issubdtype(a.dtype, np.floating)
                else a.astype(np.float32))

    key_arr = as_float(fields[key])
    L = key_arr.shape[-1]
    flatk = key_arr.reshape(-1, L)
    nan = np.isnan(flatk)
    lead = np.where(nan.all(-1), 0, np.argmax(~nan, axis=-1))
    idx = lead[:, None] + np.arange(L)[None, :]
    valid = idx < L
    idx = np.minimum(idx, L - 1)
    out = {}
    for k, v in fields.items():
        v = as_float(v)
        shifted = np.take_along_axis(v.reshape(-1, L), idx, axis=-1)
        shifted[~valid] = np.nan
        out[k] = shifted.reshape(v.shape)
    return out
