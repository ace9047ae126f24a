"""Out-of-core streaming execution over column chunks.

Port of ``xarray_parcel_tpu.parallel.stream`` for one device.  The
reference handles grids larger than memory by dask chunking; here fixed-size
column chunks stream through the device: chunk k+1 is copied from a pinned
host buffer on a side CUDA stream while chunk k computes on the current
stream, and chunk k-1's results are read back into pinned buffers on a
third stream; a staging thread fills chunk k+1's pinned buffers meanwhile,
since launching chunk k keeps the calling thread busy.  Every chunk has one
shape (the last is NaN-padded), so the
column program only ever sees that shape, and device memory holds at most
``prefetch + 1`` chunks.

Tensors cross streams here, and PyTorch's caching allocator hands a freed
block back to the stream it was allocated on without waiting for any other:
every tensor that another stream reads is ``record_stream``-ed on that
stream, and each consumer waits for its producer's event.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._device import resolve_device
from .chunked import pad_fill


def _batch_shape(dat, level_vars):
    for k in level_vars:
        if k in dat:
            return np.shape(dat[k])[:-1]
    raise ValueError('no level variable found to infer the batch shape')


def _fill(buffer, rows):
    """Copy ``rows`` into the head of the numpy ``buffer`` and pad the
    rest (NaN for floats, zero for ints and bools)."""
    n = rows.shape[0]
    np.copyto(buffer[:n], rows)
    if n < buffer.shape[0]:
        buffer[n:] = pad_fill(buffer.dtype)


class _Slot:
    """One chunk in flight: pinned input and output buffers, and the events
    that order its copies against its compute."""

    def __init__(self, flat, n_chunk):
        self.inputs = {
            k: torch.empty((n_chunk,) + v.shape[1:],
                           dtype=torch.from_numpy(v[:0]).dtype,
                           pin_memory=True)
            for k, v in flat.items()}
        self.outputs = None             # pinned, made from the first result
        self.copied_in = torch.cuda.Event()
        self.copied_out = torch.cuda.Event()
        self.rows = 0
        self.start = 0

    def fill(self, flat, start, rows):
        """Stage rows ``start:start + rows`` of every field in the pinned
        input buffers, once their last copy to the device is done."""
        self.copied_in.synchronize()
        for k, v in flat.items():
            _fill(self.inputs[k].numpy(), v[start:start + rows])


def _stream_cuda(fn, flat, B, n_chunk, prefetch, device):
    """The CUDA path of :func:`stream_map` on the flattened fields; returns
    the dict of merged host arrays, each with leading dim ``B``."""
    compute = torch.cuda.current_stream(device)
    h2d = torch.cuda.Stream(device)
    d2h = torch.cuda.Stream(device)
    prefetch = max(1, prefetch)
    slots = [_Slot(flat, n_chunk) for _ in range(prefetch + 1)]
    starts = list(range(0, B, n_chunk))
    merged = {}
    in_flight = []

    def finish(slot):
        slot.copied_out.synchronize()
        for k, buf in slot.outputs.items():
            if k not in merged:
                merged[k] = np.empty((B,) + tuple(buf.shape[1:]),
                                     buf.numpy().dtype)
            merged[k][slot.start:slot.start + slot.rows] = \
                buf.numpy()[:slot.rows]

    def stage(i):
        # On the staging thread (numpy's copy releases the GIL): chunk i
        # into its slot, whose last user, chunk i - len(slots), was finished
        # before this was submitted.
        rows = min(n_chunk, B - starts[i])
        slots[i % len(slots)].fill(flat, starts[i], rows)
        return rows

    with torch.cuda.device(device), ThreadPoolExecutor(1) as stager:
        staged = stager.submit(stage, 0)
        for i, start in enumerate(starts):
            # At most `prefetch` chunks resident beyond the one read back:
            # this one, and prefetch - 1 still computing or reading back.
            while len(in_flight) > prefetch - 1:
                finish(in_flight.pop(0))
            slot = slots[i % len(slots)]
            slot.start, slot.rows = start, staged.result()
            if i + 1 < len(starts):
                # The next chunk is staged while this one's launches keep
                # the host busy.
                staged = stager.submit(stage, i + 1)
            with torch.cuda.stream(h2d):
                chunk = {k: buf.to(device, non_blocking=True)
                         for k, buf in slot.inputs.items()}
                slot.copied_in.record(h2d)
            compute.wait_event(slot.copied_in)
            for x in chunk.values():
                x.record_stream(compute)
            out = fn(chunk)
            done = torch.cuda.Event()
            done.record(compute)
            del chunk
            if slot.outputs is None:
                slot.outputs = {
                    k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in out.items()}
            with torch.cuda.stream(d2h):
                d2h.wait_event(done)
                for k, v in out.items():
                    slot.outputs[k].copy_(v, non_blocking=True)
                    v.record_stream(d2h)
                slot.copied_out.record(d2h)
            del out
            in_flight.append(slot)
        for slot in in_flight:
            finish(slot)
    return merged


def _stream_cpu(fn, flat, B, n_chunk):
    """The CPU path of :func:`stream_map`: the same chunks, one after the
    other."""
    results = []
    for start in range(0, B, n_chunk):
        rows = min(n_chunk, B - start)
        chunk = {}
        for k, v in flat.items():
            buf = np.empty((n_chunk,) + v.shape[1:], v.dtype)
            _fill(buf, v[start:start + rows])
            chunk[k] = torch.from_numpy(buf)
        results.append({k: v.numpy()[:rows] for k, v in fn(chunk).items()})
    return {k: np.concatenate([r[k] for r in results])
            for k in results[0]}


def stream_map(fn, dat, batch_columns=1 << 16,
               level_vars=('pressure', 'temperature', 'dewpoint',
                           'specific_humidity'), prefetch=2, device=None):
    """Run ``fn`` (a dict -> dict column program on tensors, e.g.
    ``pipeline.conv_properties``) over ``dat`` in column chunks.

    ``dat``: dict of host arrays, batch dims leading ((…, L) level fields
    or (…) surface fields).  Returns a dict of host numpy arrays with the
    full batch shape.  Chunks are NaN-padded to one shape; ``fn`` gets a
    dict of tensors on ``device`` (None: the GPU) with leading dim
    ``batch_columns`` and returns a dict of tensors with the same leading
    dim.

    ``prefetch``: how many chunks may be resident on the device beyond the
    one being read back (default 2: double buffering).  On a CUDA device
    the copies run on side streams from and to pinned host buffers, so that
    a chunk's transfer in, the previous chunk's compute and the one
    before's readback overlap; on the CPU the chunks run one after the
    other.
    """
    device = resolve_device(device)
    batch = _batch_shape(dat, level_vars)
    B = int(np.prod(batch)) if batch else 1
    flat = {}
    for k, v in dat.items():
        v = np.asarray(v)
        flat[k] = v.reshape((B,) + v.shape[len(batch):])

    n_chunk = max(1, min(int(batch_columns), B))
    if B == 0:
        # Empty batch: one padding row gives the output structure.
        chunk = {k: torch.full((1,) + v.shape[1:], pad_fill(v.dtype),
                               dtype=torch.from_numpy(v).dtype,
                               device=device)
                 for k, v in flat.items()}
        return {k: v.cpu().numpy()[:0].reshape(batch + tuple(v.shape[1:]))
                for k, v in fn(chunk).items()}
    if device.type == 'cuda':
        merged = _stream_cuda(fn, flat, B, n_chunk, prefetch, device)
    else:
        merged = _stream_cpu(fn, flat, B, n_chunk)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in merged.items()}
