"""Profiling and timing instrumentation.

Port of ``xarray_parcel_tpu.utils.profiling``: a timer that waits for the
device, a columns/sec throughput counter (the framework's headline unit), a
context manager around ``torch.profiler`` that writes a Chrome trace, and
accumulating named wall-clock sections.  ``span`` (defined in ``_build``
beside the kernels' launch counters) is the program's own mark on that
trace.

PyTorch returns from a CUDA call before the device has finished, so every
timed region here ends by synchronising each CUDA device that holds one of
the result's tensors; results on the CPU need nothing.
"""

import contextlib
import os
import tempfile
import time

import torch

from .._build import span  # noqa: F401  (re-export)
from ..parallel.chunked import _tree_leaves as _leaves


def _finish(out):
    """Wait for every CUDA device that holds a tensor of ``out`` (also the
    shards of a ``parallel.Sharded``)."""
    devices = set()
    for leaf in _leaves(out):
        for x in getattr(leaf, 'shards', {None: leaf}).values():
            if torch.is_tensor(x) and x.device.type == 'cuda':
                devices.add(x.device)
    for device in devices:
        torch.cuda.synchronize(device)
    return out


def time_function(f, *args, **kwargs):
    """(result, seconds) of ``f(*args)`` with device work finished: the
    analogue of the reference's ``time_function``, whose ``.load()`` is the
    device synchronise here."""
    start = time.perf_counter()
    res = _finish(f(*args, **kwargs))
    return res, time.perf_counter() - start


def infer_columns(args):
    """Column count implied by the first array argument: the product of
    its leading (batch) dims.  A 1-D first argument is ambiguous (a batch
    of points or one column of levels); it counts as a batch, pointwise
    functions being the common 1-D case.  Pass ``columns=`` explicitly to
    time a single column."""
    first = next(_leaves(args))
    if first.ndim <= 1:
        return int(first.shape[0]) if first.ndim else 1
    columns = 1
    for d in first.shape[:-1]:
        columns *= int(d)
    return columns


def columns_per_second(f, *args, columns=None, iters=5, warmup=1, **kwargs):
    """Steady-state throughput of ``f`` in columns/sec: ``iters`` calls
    issued back to back after ``warmup`` finished ones, then one wait for
    all of them.

    ``columns`` defaults to ``infer_columns(args)`` (all batch dims are
    columns, the framework's unit of work).
    Returns (columns_per_sec, seconds_per_iter).
    """
    if columns is None:
        columns = infer_columns(args)
    for _ in range(warmup):
        _finish(f(*args, **kwargs))
    t0 = time.perf_counter()
    outs = [f(*args, **kwargs) for _ in range(iters)]
    _finish(outs)
    sec = (time.perf_counter() - t0) / iters
    return columns / sec, sec


@contextlib.contextmanager
def trace(log_dir=None):
    """Profiler trace (host, and the device when there is one) around a
    block::

        with utils.trace('traces'):
            run(dat)

    Writes ``trace_<pid>_<ns>.json`` into ``log_dir`` (None: an
    ``xparcel_trace`` directory under ``tempfile.gettempdir()``, which
    follows ``TMPDIR``): a Chrome trace, for Perfetto or
    ``chrome://tracing``.  Besides the host's operations, runtime calls and
    the device's kernels and copies, it holds the program's ``xparcel.*``
    spans (:func:`span`): the Dataset surface's lower, to_device, compute,
    to_host and lift, the fused pipelines and their outputs, each parcel
    prep, the pre-pass and both kernels.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), 'xparcel_trace')
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


class Timer:
    """Accumulating named wall-clock sections (host-side)::

        tm = Timer()
        with tm('ingest'): ...
        with tm('solve'): ...
        print(tm.report())
    """

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = (self.sections.get(name, 0.0) +
                                   time.perf_counter() - t0)

    def report(self):
        total = sum(self.sections.values()) or 1.0
        lines = [f'{k:20s} {v:9.3f}s  {100 * v / total:5.1f}%'
                 for k, v in sorted(self.sections.items(),
                                    key=lambda kv: -kv[1])]
        return '\n'.join(lines)
