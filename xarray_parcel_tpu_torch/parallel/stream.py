"""Out-of-core streaming execution over column chunks.

Port of ``xarray_parcel_tpu.parallel.stream``.  The
reference handles grids larger than memory by dask chunking; here fixed-size
column chunks stream through the device: chunk k+1 is copied from a pinned
host buffer on a side CUDA stream while chunk k computes on the current
stream, and chunk k-1's results are read back into pinned buffers on a
third stream; a staging thread fills chunk k+1's pinned buffers meanwhile,
since launching chunk k keeps the calling thread busy; its waits for a
staged chunk and for a readback are the spans
``xparcel.stream.wait_staged`` and ``xparcel.stream.wait_readback``.
Every chunk has one shape (the last is NaN-padded), so the
column program only ever sees that shape, and device memory holds at most
``prefetch + 1`` chunks.  With a mesh every chunk is split over its entries,
and each entry streams its share on its own thread with its own copy
streams, pinned slots and events.

Tensors cross streams here, and PyTorch's caching allocator hands a freed
block back to the stream it was allocated on without waiting for any other:
every tensor that another stream reads is ``record_stream``-ed on that
stream, and each consumer waits for its producer's event.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._build import span
from .._device import resolve_device
from .chunked import pad_fill
from .mesh import check_device_in_mesh, run_entries


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


class _Merged:
    """The merged host outputs, each with leading dim ``B``: made from the
    first chunk that finishes, filled by every entry's thread at its own
    rows."""

    def __init__(self, B):
        self.B = B
        self.arrays = {}
        self.lock = threading.Lock()

    def write(self, start, rows, out):
        """Rows ``start:start + rows`` from the head of each numpy array
        of ``out``."""
        with self.lock:
            for k, v in out.items():
                if k not in self.arrays:
                    self.arrays[k] = np.empty((self.B,) + v.shape[1:],
                                              v.dtype)
        for k, v in out.items():
            self.arrays[k][start:start + rows] = v[:rows]


def _stream_cuda(fn, flat, pieces, n_rows, prefetch, device, merged):
    """One CUDA device's share of :func:`stream_map`: the ``pieces``
    (``(start, rows)`` of the flattened fields, each padded to ``n_rows``)
    through ``fn`` on ``device``, with this device's own copy streams,
    pinned slots and events, into ``merged``."""
    compute = torch.cuda.current_stream(device)
    h2d = torch.cuda.Stream(device)
    d2h = torch.cuda.Stream(device)
    prefetch = max(1, prefetch)
    slots = [_Slot(flat, n_rows) for _ in range(prefetch + 1)]
    in_flight = []

    def finish(slot):
        with span('xparcel.stream.wait_readback'):
            slot.copied_out.synchronize()
        merged.write(slot.start, slot.rows,
                     {k: buf.numpy() for k, buf in slot.outputs.items()})

    def stage(i):
        # On the staging thread (numpy's copy releases the GIL): piece i
        # into its slot, whose last user, piece i - len(slots), was finished
        # before this was submitted.
        start, rows = pieces[i]
        slots[i % len(slots)].fill(flat, start, rows)

    with torch.cuda.device(device), ThreadPoolExecutor(1) as stager:
        staged = stager.submit(stage, 0)
        for i, (start, rows) in enumerate(pieces):
            # At most `prefetch` chunks resident beyond the one read back:
            # this one, and prefetch - 1 still computing or reading back.
            while len(in_flight) > prefetch - 1:
                finish(in_flight.pop(0))
            slot = slots[i % len(slots)]
            slot.start, slot.rows = start, rows
            with span('xparcel.stream.wait_staged'):
                staged.result()
            if i + 1 < len(pieces):
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


def _stream_cpu(fn, flat, pieces, n_rows, merged):
    """The CPU's share of :func:`stream_map`: the same pieces, one after
    the other."""
    for start, rows in pieces:
        chunk = {}
        for k, v in flat.items():
            buf = np.empty((n_rows,) + v.shape[1:], v.dtype)
            _fill(buf, v[start:start + rows])
            chunk[k] = torch.from_numpy(buf)
        merged.write(start, rows,
                     {k: v.numpy() for k, v in fn(chunk).items()})


def stream_map(fn, dat, batch_columns=1 << 16,
               level_vars=('pressure', 'temperature', 'dewpoint',
                           'specific_humidity'), prefetch=2, device=None,
               mesh=None):
    """Run ``fn`` (a dict -> dict column program on tensors, e.g.
    ``pipeline.conv_properties``) over ``dat`` in column chunks.

    ``dat``: dict of host arrays, batch dims leading ((…, L) level fields
    or (…) surface fields).  Returns a dict of host numpy arrays with the
    full batch shape.  Chunks are NaN-padded to one shape; ``fn`` gets a
    dict of tensors on ``device`` (None: the GPU) with leading dim
    ``batch_columns`` and returns a dict of tensors with the same leading
    dim.

    ``mesh``: shard every chunk's batch dim over the mesh's first axis, so
    that grids larger than one device's memory stream through all devices:
    the out-of-core and the data-parallel paths compose.  The chunk size
    rounds up to a multiple of the mesh size (padded columns are NaN and
    sliced off as usual); ``fn`` is called once per chunk and mesh entry,
    on that entry's thread, with that entry's share of the chunk on its
    device (tables go with ``parallel.replicate(tables, mesh).on(device)``).
    The mesh's devices are where the chunks run: ``device`` must then be
    None or one of them.  Across processes each computes its entries'
    shares and all get the whole result (every process must make the call).

    ``prefetch``: how many chunks may be resident on a device beyond the
    one being read back (default 2: double buffering).  On a CUDA device
    the copies run on side streams from and to pinned host buffers, so that
    a chunk's transfer in, the previous chunk's compute and the one
    before's readback overlap; on the CPU the chunks run one after the
    other.
    """
    if mesh is None:
        entries = [((0,), resolve_device(device))]
        n_split = n_round = 1
    else:
        entries = mesh.entries(1)
        check_device_in_mesh(device, mesh)
        n_split, n_round = mesh.devices.shape[0], mesh.devices.size
    batch = _batch_shape(dat, level_vars)
    B = int(np.prod(batch)) if batch else 1
    flat = {}
    for k, v in dat.items():
        v = np.asarray(v)
        flat[k] = v.reshape((B,) + v.shape[len(batch):])

    n_chunk = max(1, min(int(batch_columns), B))
    n_chunk += (-n_chunk) % n_round
    n_rows = n_chunk // n_split
    if B == 0:
        # Empty batch: one padding row gives the output structure.
        device = entries[0][1]
        chunk = {k: torch.full((1,) + v.shape[1:], pad_fill(v.dtype),
                               dtype=torch.from_numpy(v).dtype,
                               device=device)
                 for k, v in flat.items()}
        return {k: v.cpu().numpy()[:0].reshape(batch + tuple(v.shape[1:]))
                for k, v in fn(chunk).items()}
    merged = _Merged(B)

    def work(key, device):
        # Entry j takes rows j * n_rows onwards of every chunk (none of
        # them past the batch's end: the piece is then all padding).
        pieces = []
        for start in range(0, B, n_chunk):
            first = start + key[0] * n_rows
            pieces.append((first, max(0, min(n_rows, B - first))))
        if device.type == 'cuda':
            _stream_cuda(fn, flat, pieces, n_rows, prefetch, device, merged)
        else:
            _stream_cpu(fn, flat, pieces, n_rows, merged)
        return pieces

    done = run_entries(work, entries)
    if mesh is not None and mesh.processes > 1:
        import torch.distributed as dist
        mine = [(start, {k: v[start:start + rows]
                         for k, v in merged.arrays.items()})
                for pieces in done for start, rows in pieces if rows]
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        for start, part in (x for g in gathered for x in g):
            rows = len(next(iter(part.values())))
            merged.write(start, rows, part)
    return {k: v.reshape(batch + v.shape[1:])
            for k, v in merged.arrays.items()}
