"""Host-side ingest helpers on numpy arrays, with a C++ fast path.

Port of ``xarray_parcel_tpu.native``: column validation, the float32
repack, the level-axis move of the Dataset ingest, and a host-side
left-compaction.  ``ingest.cc`` (host C++ with ``std::thread``; the JAX
package's source) is built with ``g++`` at first use into
``build/xarray_parcel_tpu_torch/`` beside the package, named by a hash of
the source and the flags as the CUDA kernels' library is, and loaded with
``ctypes``.  Every entry point also has a numpy form, which is the path
when there is no compiler or the build fails; :func:`available` says which
one is in use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'ingest.cc')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')
_lock = threading.Lock()
_lib = None
_tried = False

# The numpy levels_to_last splits arrays of at least this many elements
# over threads.
_THREADED_FROM = 1 << 22
_THREADS = min(8, os.cpu_count() or 1)


def library_path():
    """Where the ingest library for this source and these flags lives."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f'libxpt_ingest_{h.hexdigest()[:16]}.so')


def _build():
    """Compile ``ingest.cc`` unless its library exists; returns the path."""
    path = library_path()
    if os.path.exists(path):
        return path
    gxx = shutil.which('g++')
    if gxx is None:
        raise FileNotFoundError('g++ not found')
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        subprocess.run([gxx, *CXX_FLAGS, _SRC, '-o', tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)   # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError):
            return None
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        for name, argtypes in (
                ('xpt_validate_columns_f32', [f32p, i64, i64, u8p]),
                ('xpt_validate_columns_f64', [f64p, i64, i64, u8p]),
                ('xpt_repack_f64_to_f32', [f64p, f32p, i64]),
                ('xpt_levels_to_last_f32', [f32p, f32p, i64, i64]),
                ('xpt_levels_to_last_f64_to_f32', [f64p, f32p, i64, i64]),
                ('xpt_compact_left_f32',
                 [f32p, ctypes.POINTER(f32p), i64, i64, i64])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        _lib = lib
        return _lib


def available():
    """True when the compiled native library is in use."""
    return _load() is not None


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def validate_columns(pressure):
    """Per-column validity of the reference's input invariant: pressure
    strictly decreasing along the trailing axis, NaN padding only at the
    top.  Returns a boolean array over the batch dims."""
    p = np.ascontiguousarray(pressure)
    batch = p.shape[:-1]
    flat = p.reshape(-1, p.shape[-1])
    lib = _load()
    if lib is not None and p.dtype in (np.float32, np.float64) and flat.size:
        ok = np.empty(flat.shape[0], np.uint8)
        if p.dtype == np.float32:
            lib.xpt_validate_columns_f32(_ptr(flat, ctypes.c_float),
                                         *flat.shape,
                                         _ptr(ok, ctypes.c_uint8))
        else:
            lib.xpt_validate_columns_f64(_ptr(flat, ctypes.c_double),
                                         *flat.shape,
                                         _ptr(ok, ctypes.c_uint8))
        return ok.astype(bool).reshape(batch)
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
    lib = _load()
    if lib is not None and a.dtype == np.float64 and a.flags.c_contiguous:
        out = np.empty(a.shape, np.float32)
        lib.xpt_repack_f64_to_f32(_ptr(a, ctypes.c_double),
                                  _ptr(out, ctypes.c_float), a.size)
        return out
    # (ascontiguousarray alone would make a 0-d array 1-d.)
    return np.ascontiguousarray(a, np.float32).reshape(a.shape)


def _levels_to_last_numpy(a):
    """The numpy form of :func:`levels_to_last`."""
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


def levels_to_last(arr):
    """Move a leading level axis to the trailing position, (L, …) -> (…, L),
    converting to contiguous float32: the Dataset ingest's repack."""
    a = np.asarray(arr)
    lib = _load()
    if (lib is None or a.dtype not in (np.float32, np.float64)
            or not a.flags.c_contiguous or a.ndim < 2 or not a.size):
        return _levels_to_last_numpy(a)
    L, n_cols = a.shape[0], a.size // a.shape[0]
    out = np.empty(a.shape[1:] + a.shape[:1], np.float32)
    if a.dtype == np.float32:
        lib.xpt_levels_to_last_f32(_ptr(a, ctypes.c_float),
                                   _ptr(out, ctypes.c_float), L, n_cols)
    else:
        lib.xpt_levels_to_last_f64_to_f32(_ptr(a, ctypes.c_double),
                                          _ptr(out, ctypes.c_float), L,
                                          n_cols)
    return out


def compact_left(fields, key):
    """Host-side left-compaction of leading NaNs (in the ``key`` field's NaN
    pattern) across a dict of (…, L) float arrays.  Float dtypes are kept:
    float32 arrays go through the C++ library when it is there, the others
    through numpy in their own precision; other dtypes are cast to float32
    so the NaN fill is representable.  Returns new arrays.  Device-side
    equivalent: ``ops.compact_left``."""
    def as_float(v):
        a = np.ascontiguousarray(v)
        return (a if np.issubdtype(a.dtype, np.floating)
                else a.astype(np.float32))

    key_arr = as_float(fields[key])
    L = key_arr.shape[-1]
    out = {k: as_float(v) for k, v in fields.items()}
    rest = out
    lib = _load()
    f32 = {k: v.copy() for k, v in out.items() if v.dtype == np.float32}
    if (lib is not None and f32 and key_arr.dtype == np.float32
            and key_arr.size):
        arrs = list(f32.values())
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(arrs))(
            *[_ptr(a, ctypes.c_float) for a in arrs])
        lib.xpt_compact_left_f32(_ptr(key_arr, ctypes.c_float), ptrs,
                                 len(arrs), key_arr.size // L, L)
        rest = {k: v for k, v in out.items() if k not in f32}
        out = {k: f32.get(k, v) for k, v in out.items()}
    if rest:
        flatk = key_arr.reshape(-1, L)
        nan = np.isnan(flatk)
        lead = np.where(nan.all(-1), 0, np.argmax(~nan, axis=-1))
        idx = lead[:, None] + np.arange(L)[None, :]
        valid = idx < L
        idx = np.minimum(idx, L - 1)
        for k, v in rest.items():
            shifted = np.take_along_axis(v.reshape(-1, L), idx, axis=-1)
            shifted[~valid] = np.nan
            out[k] = shifted.reshape(v.shape)
    return out
