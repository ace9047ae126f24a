"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of the package for
Hopper (``sm_90a``), one process per source, all started together, and
links the objects into one shared library with a plain C interface, which
``ctypes`` loads.  The library lands in ``build/xarray_parcel_tpu_torch/``
beside the package, named by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and an unchanged tree loads the existing library.

``kernels_from`` makes ``launch`` take the kernels of another tree's
``csrc/`` with the same C interface, built and named the same way, so two
trees' kernels can be timed through the same wrappers in one process.

There is no fallback: a missing ``nvcc`` or a failed build raises.  Fast
math stays off, because the CAPE/CIN solve's selections depend on IEEE
``exp``/``log``/divide and on NaN semantics.

What the program records of itself lives here too: the counters
(:func:`count`; ``_kernels`` counts each kernel's launches with it) and
the ``xparcel.*`` spans (:func:`span`).
"""

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build',
                         'xarray_parcel_tpu_torch')
# -fmad=false: no contraction of a*b+c into one fused multiply-add, so the
# kernel rounds op for op as the plain twin's separate torch ops do.  With
# contraction, float64 LFC/EL selections flipped on knife-edge columns
# (a 52.7 J/kg CAPE miss in 8,220 test columns) and float32 ones on 260 of
# 786,432 columns; without it the selections agree exactly, at no measured
# cost in kernel time on the H100.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded = {}                    # sources directory -> loaded library
_active = CSRC                  # whose kernels launch() calls


def sources(csrc=CSRC):
    """The kernel sources, in a stable order."""
    return sorted(glob.glob(os.path.join(csrc, '*.cu')))


def headers(csrc=CSRC):
    """The headers the sources share, in a stable order."""
    return sorted(glob.glob(os.path.join(csrc, '*.cuh')))


def find_nvcc():
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises if there is none."""
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found (looked on PATH, $CUDA_HOME/bin and '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be '
                       'built')


def library_path(csrc=CSRC):
    """Where the library for the sources and headers in ``csrc`` and the
    flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources(csrc) + headers(csrc):
        h.update(os.path.basename(src).encode())
        with open(src, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'libxpt_kernels_{h.hexdigest()[:16]}.so')


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's
    output after all have ended.  Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{out}')
    return ''.join(outs)


def build(verbose=False, csrc=CSRC):
    """Compile the sources in ``csrc`` unless the library for them exists.
    Returns ``(path, seconds)``: seconds is 0.0 when nothing was compiled.
    With ``verbose``, passes ``-Xptxas -v`` and prints the compiler's
    report of registers, shared memory and spills."""
    path = library_path(csrc)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f'{path}.{os.getpid()}.tmp'
    objs = [f'{tmp}.{os.path.basename(src)}.o' for src in sources(csrc)]
    t0 = time.perf_counter()
    try:
        report = _run_all([[nvcc, *NVCC_FLAGS,
                            *(['-Xptxas', '-v'] if verbose else []),
                            '-c', '-o', obj, src]
                           for src, obj in zip(sources(csrc), objs)])
        _run_all([[nvcc, '-shared', '-o', tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    if verbose:
        print(report, end='', flush=True)
    os.replace(tmp, path)       # atomic: concurrent builds race safely
    return path, seconds


def load_library(csrc=None):
    """The kernel library of ``csrc`` (by default the one :func:`launch`
    calls), built and loaded at first use in the process."""
    csrc = csrc or _active
    with _lock:
        if csrc not in _loaded:
            path, _ = build(csrc=csrc)
            _loaded[csrc] = ctypes.CDLL(path)
        return _loaded[csrc]


@contextlib.contextmanager
def kernels_from(csrc):
    """Within the block, :func:`launch` calls the kernels built from the
    sources in ``csrc``: another tree's ``csrc/`` with the same C
    interface, for timing its kernels against this tree's through the same
    wrappers."""
    global _active
    before, _active = _active, os.path.abspath(csrc)
    try:
        yield
    finally:
        _active = before


def count(owner, name, n=1):
    """Add ``n`` to ``owner.<name>``, a counter kept as an attribute.
    Under a lock: ``parallel.sharded_map`` and ``stream_map(mesh=)`` call
    the program from one thread per mesh entry, and an unguarded ``+=``
    would lose counts."""
    with _count_lock:
        setattr(owner, name, getattr(owner, name) + n)


_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context manager that marks its block as ``name`` on the
    ``torch.profiler`` trace (``record_function``), on the same clock as
    the kernels, copies and runtime calls, while a profiler records; else
    one shared null context, at the cost of a flag check.  The program's
    spans are named ``xparcel.<layer>.<stage>``.  A span opened on a
    worker thread (``stream_map``'s stager, a mesh entry's thread) does
    not reach the trace."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def launch(name, device, pointers, batch, *widths):
    """Call the library's launcher ``name`` on ``device``'s current stream
    (``_kernels.Kernel`` is the one caller).

    Every launcher has the C signature ``int name(void *..., int64_t B,
    int or double..., void *stream)``: ``pointers`` are the tensors' data
    pointers, ``batch`` the column count B and ``widths`` the sizes that
    follow it, a Python int as a C int and a float as a double.  Raises if
    the launch reports a CUDA error."""
    fn = getattr(load_library(), name)
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int64] +
                   [ctypes.c_double if isinstance(w, float) else ctypes.c_int
                    for w in widths] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*pointers, batch, *widths, stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')
