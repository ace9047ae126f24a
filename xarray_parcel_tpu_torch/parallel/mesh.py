"""Device-mesh data parallelism over grid columns.

Port of ``xarray_parcel_tpu.parallel.mesh``.  Columns are independent, so
the leading (batch) axis shards over a mesh of devices while the level axis
stays whole on each device and the adiabat tables are replicated; the
pipelines need no communication, which appears only in the explicit global
reductions (:func:`global_stats`).

PyTorch has no single array that spans devices and could also be handed to
the port's kernels: they are launched through ``ctypes`` on raw data
pointers (``_build.launch``), which a ``DTensor`` cannot pass through.  So
this module keeps its own small types.  A :class:`Mesh` is an array of
``torch.device`` with axis names; a :class:`Sharded` is the list of
per-device tensors this process holds of one global array; a
:class:`Replicated` is one copy of a tree per device.  :func:`sharded_map`
runs a function on every shard, each on its own device and its own host
thread: the fused pipelines are bound by the host's launch rate, so one
thread walking the devices in turn would feed several cards no faster than
one.  The same device may appear in a mesh more than once (``['cpu'] * 8``
is an 8-way mesh on the host; ``['cuda:0'] * 2`` runs two shards
concurrently on one card, sharing its current stream).

Axes of a mesh beyond the sharded batch dims are replica axes.  Eager
PyTorch has no use for a second copy of a shard's work, so only the entries
with index 0 along them hold shards and compute.

Several processes: after :func:`distributed_init`, :func:`make_mesh` spans
every process's devices, each process holds and computes the shards of its
own entries, and :meth:`Sharded.numpy` and :func:`global_stats` cross the
process boundary through ``torch.distributed`` (NCCL on cards, gloo on the
host).
"""

import contextlib
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .._device import to_tensor
from .chunked import _map_leaves, _tree_leaves, _zip_leaves, pad_fill

_PASS = (type(None), bool, int, float, str)


def _group_up():
    return dist.is_available() and dist.is_initialized()


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join this process to a group of ``num_processes``: the launch-side
    counterpart of the reference's dask LocalCluster/Client setup.

    Thin wrapper over ``torch.distributed.init_process_group``: NCCL when
    the process has a CUDA device, else gloo.  ``coordinator_address`` is
    ``host:port`` of rank 0; with none, the environment says it
    (``MASTER_ADDR``, ``RANK``, ... as ``torchrun`` sets them).  Call once
    per process before :func:`make_mesh`, which then spans every process.
    With several processes and CUDA, each takes one card: ``LOCAL_RANK``'s,
    else its rank's modulo the card count.
    """
    cuda = torch.cuda.is_available()
    rank = int(os.environ.get('RANK', 0) if process_id is None
               else process_id)
    world = int(os.environ.get('WORLD_SIZE', 1) if num_processes is None
                else num_processes)
    if cuda and world > 1:
        torch.cuda.set_device(int(os.environ.get(
            'LOCAL_RANK', rank % torch.cuda.device_count())))
    backend = 'nccl' if cuda else 'gloo'
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f'tcp://{coordinator_address}',
            world_size=world, rank=rank)


class Mesh:
    """An array of devices with named axes.

    ``devices``: object ndarray of ``torch.device``; ``axis_names``: one
    name per axis; ``shape``: ``{axis name: size}``; ``ranks``: the process
    that holds each entry; ``rank``: this process.  The batch shards over
    the leading axes (:func:`batch_spec`).
    """

    def __init__(self, devices, axis_names, ranks=None, rank=0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f'{devices.ndim} mesh axes but names '
                             f'{self.axis_names}')
        self.ranks = (np.zeros(devices.shape, int) if ranks is None
                      else ranks)
        self.rank = rank

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    @property
    def processes(self):
        """How many processes hold entries of the mesh."""
        return len(set(self.ranks.ravel().tolist()))

    def entries(self, batch_dims=1):
        """``(key, device)`` of every entry this process computes on:
        ``key`` is the entry's index along the first ``batch_dims`` axes
        (which shard of the batch it holds); entries off index 0 of a
        replica axis are left out."""
        out = []
        for idx in np.ndindex(*self.devices.shape):
            if any(idx[batch_dims:]) or self.ranks[idx] != self.rank:
                continue
            out.append((idx[:batch_dims], self.devices[idx]))
        return out

    def local_devices(self):
        """This process's distinct devices, in mesh order."""
        seen = []
        for idx in np.ndindex(*self.devices.shape):
            dev = self.devices[idx]
            if self.ranks[idx] == self.rank and dev not in seen:
                seen.append(dev)
        return seen

    def __repr__(self):
        return (f'Mesh({self.shape}, devices='
                f'{[str(d) for d in self.devices.ravel()]})')


def _device(d):
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


def make_mesh(devices=None, axis_names=('data',), shape=None):
    """Build a mesh with the given axis names; ``shape`` defaults to all
    devices on the first axis.

    ``devices`` are this process's (any ``torch.device`` spelling; the same
    one may repeat).  The default is every CUDA device the process sees,
    or, in a group of several processes, its current one.  Once
    :func:`distributed_init` has run, the mesh holds every process's
    devices in rank order; every process must then make the call (it
    gathers the lists).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device to build a mesh from; pass devices= (for "
                "example ['cpu'] * 8) to build one on the host")
        if _group_up() and dist.get_world_size() > 1:
            devices = [torch.cuda.current_device()]
        else:
            devices = range(torch.cuda.device_count())
        devices = [torch.device('cuda', i) for i in devices]
    entries = [(0, _device(d)) for d in devices]
    rank = 0
    if _group_up() and dist.get_world_size() > 1:
        rank = dist.get_rank()
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for _, d in entries])
        entries = [(r, torch.device(d)) for r, ds in enumerate(gathered)
                   for d in ds]
    n = len(entries)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {tuple(shape)} does not hold {n} '
                         'devices')
    devs = np.empty(n, object)
    devs[:] = [d for _, d in entries]
    ranks = np.array([r for r, _ in entries], int)
    return Mesh(devs.reshape(shape), axis_names, ranks.reshape(shape), rank)


def check_device_in_mesh(device, mesh):
    """Where a caller passes both: the mesh's devices are where the work
    runs, and a ``device`` (not None) that is none of them raises."""
    if device is not None and _device(device) not in mesh.local_devices():
        raise ValueError(
            f'device {device} is not in the mesh '
            f'{[str(d) for d in mesh.local_devices()]}: with mesh= the '
            "mesh's devices are where the work runs")


def replicated(mesh):
    """The spec of an array held whole on every device: no axis names."""
    return ()


def batch_spec(mesh, ndim, batch_dims=1):
    """The spec that shards the leading ``batch_dims`` dims over the mesh
    axes (one mesh axis per batch dim, in order) and keeps the rest whole:
    a tuple of axis names and ``None``."""
    names = list(mesh.axis_names[:batch_dims])
    return tuple(names + [None] * (ndim - len(names)))


def _numpy_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


class Sharded:
    """One global array as the shards this process holds.

    ``shards``: ``{key: tensor}``, ``key`` the index along the mesh's
    first ``batch_dims`` axes, each tensor on its entry's device;
    ``shape``/``dtype``: the global array's; ``spec``: its
    :func:`batch_spec`.  :meth:`numpy` (also ``np.asarray``) gives the whole
    array on the host.
    """

    def __init__(self, mesh, shape, dtype, shards, batch_dims):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.shards = shards
        self.batch_dims = batch_dims

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def spec(self):
        return batch_spec(self.mesh, self.ndim, self.batch_dims)

    @property
    def devices(self):
        return {x.device for x in self.shards.values()}

    def _slices(self, key):
        return tuple(
            slice(k * (s // n), (k + 1) * (s // n))
            for k, s, n in zip(key, self.shape, self.mesh.devices.shape))

    def numpy(self):
        """The whole array on the host; across processes, gathered so that
        each gets the full value (every process must call it)."""
        parts = {k: v.detach().cpu().numpy() for k, v in self.shards.items()}
        if self.mesh.processes > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, parts)
            parts = {k: v for g in gathered for k, v in g.items()}
        out = np.empty(self.shape, _numpy_dtype(self.dtype))
        for key, part in parts.items():
            out[self._slices(key)] = part
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)

    def __repr__(self):
        return (f'Sharded(shape={self.shape}, dtype={self.dtype}, '
                f'spec={self.spec}, {len(self.shards)} local shards)')


class Replicated:
    """One copy of a tree per device of a mesh; :meth:`on` gives a
    device's.  :func:`sharded_map` hands each shard's call its device's
    copy of a ``Replicated`` argument."""

    def __init__(self, mesh, copies):
        self.mesh = mesh
        self.copies = copies

    def on(self, device):
        return self.copies[_device(device)]


def _place(x, device):
    """A leaf on ``device``: modules (the adiabat tables) and tensors that
    are there already are used as they are."""
    if isinstance(x, _PASS):
        return x
    if isinstance(x, nn.Module):
        where = {b.device for b in x.buffers()} | {
            p.device for p in x.parameters()}
        return x if where <= {device} else copy.deepcopy(x).to(device)
    return to_tensor(x, device)


def replicate(tree, mesh):
    """A copy of ``tree`` (tensors, host arrays, modules such as
    ``AdiabatTables``, in dicts, lists and tuples) on each distinct device
    of the mesh that this process holds: for the adiabat tables."""
    return Replicated(mesh, {
        dev: _map_leaves(lambda x: _place(x, dev), tree)
        for dev in mesh.local_devices()})


def shard_batch(tree, mesh, batch_dims=1):
    """Every array of a tree (dicts, lists, tuples) as a :class:`Sharded`
    with its leading batch dims split over the mesh: the host-to-device
    ingest boundary.  Each shard goes straight from the host array to its
    own device, never whole onto one device first.

    Every leaf must carry the full leading batch prefix: a surface field
    (B,) shards its only dim, a level field (B, L) its first.  (A shared
    level-only vector (L,) would be indistinguishable from a surface field
    by shape: broadcast such fields to the batch before ingest.)  A batch
    that does not divide its mesh axis raises; :func:`pad_batch` first.
    ``None``, Python scalars, 0-d arrays, :class:`Replicated` and
    :class:`Sharded` leaves pass as they are.
    """
    def put(x):
        if isinstance(x, _PASS + (Replicated,)):
            return x
        if isinstance(x, Sharded):
            if x.mesh is not mesh:
                raise ValueError('a Sharded leaf of another mesh')
            return x
        if not torch.is_tensor(x):
            x = np.asarray(x)
        if x.ndim == 0:
            return torch.as_tensor(x)
        bd = min(batch_dims, x.ndim)
        for d in range(bd):
            n = mesh.devices.shape[d]
            if x.shape[d] % n:
                raise ValueError(
                    f'batch dim {d} of size {x.shape[d]} does not divide '
                    f'the {n}-way mesh axis {mesh.axis_names[d]!r}: pad to '
                    'a multiple first (parallel.pad_batch)')
        out = Sharded(mesh, x.shape, None, {}, bd)
        for key, dev in mesh.entries(bd):
            out.shards[key] = to_tensor(x[out._slices(key)], dev)
        out.dtype = to_tensor(x[:0], 'cpu').dtype
        return out
    return _map_leaves(put, tree)


def pad_batch(tree, mesh, fill=np.nan):
    """Pad every array's leading dim to a multiple of the mesh size, on the
    host.

    A sharded dim must divide evenly; real grids rarely do.  Columns are
    independent and every op is NaN-transparent, so the production recipe
    is pad -> shard -> compute -> slice.  Float leaves pad with ``fill``
    (NaN); integer/bool leaves (station ids, flags) pad with zero, since
    NaN has no representation there and the padded rows are sliced off
    regardless.  Returns ``(padded_tree, original_batch)``; slice outputs
    with ``[:original]``.
    """
    n = mesh.devices.size
    leaves = list(_tree_leaves(tree))
    if not leaves:
        raise ValueError('empty pytree — nothing to pad')
    sizes = {np.asarray(x).shape[0] for x in leaves}
    if len(sizes) != 1:
        raise ValueError(f'mixed leading-dim sizes: {sorted(sizes)}')
    b = sizes.pop()
    pad = (-b) % n

    def one(x):
        x = np.asarray(x)
        if not pad:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths,
                      constant_values=pad_fill(x.dtype, float_fill=fill))

    return _map_leaves(one, tree), b


def _on(device):
    return (torch.cuda.device(device) if device.type == 'cuda'
            else contextlib.nullcontext())


def run_entries(work, entries):
    """``work(key, device)`` for every mesh entry, each on its own thread
    (inline when there is one), with the device current and the caller's
    grad mode; the results in the entries' order."""
    grad = torch.is_grad_enabled()

    def one(entry):
        with _on(entry[1]), torch.set_grad_enabled(grad):
            return work(*entry)

    if len(entries) == 1:
        return [one(entries[0])]
    with ThreadPoolExecutor(len(entries)) as pool:
        futures = [pool.submit(one, entry) for entry in entries]
        return [f.result() for f in futures]


def sharded_map(fn, mesh, batch_dims=1):
    """Wrap ``fn`` so that its array arguments shard their leading batch
    dims over the mesh (:func:`shard_batch`), ``fn`` runs on every shard on
    that shard's device, and its outputs come back as :class:`Sharded`
    leaves: the counterpart of the JAX package's ``sharded_jit`` (eager
    PyTorch has nothing to compile and no buffers to donate).

    Each mesh entry's call runs on its own host thread with the device
    current, so several cards are fed concurrently; a :class:`Replicated`
    argument reaches each call as that device's copy.  ``fn`` returns
    tensors, or dicts, lists and tuples of them, with the shards' leading
    dims.
    """
    def wrapper(*args, **kwargs):
        args, kwargs = shard_batch((args, kwargs), mesh, batch_dims)
        entries = mesh.entries(batch_dims)

        def work(key, device):
            def pick(x):
                if isinstance(x, Sharded):
                    return x.shards[key[:x.batch_dims]]
                return x.on(device) if isinstance(x, Replicated) else x
            a, kw = _map_leaves(pick, (args, kwargs))
            return fn(*a, **kw)

        outs = run_entries(work, entries)

        def gather(leaves):
            first = leaves[0]
            if not torch.is_tensor(first):
                return first
            bd = min(batch_dims, first.dim())
            shape = [s * n for s, n in zip(first.shape, mesh.devices.shape)
                     ][:bd] + list(first.shape[bd:])
            return Sharded(mesh, shape, first.dtype,
                           {key[:bd]: x
                            for (key, _), x in zip(entries, leaves)}, bd)

        return _zip_leaves(gather, outs)
    return wrapper


def global_stats(x, mesh, axis_name='data'):
    """Statistics of a sharded field over the whole mesh: (finite count,
    mean, max), the validation reductions that are this workload's only
    communication.  Reduced over this process's shards on their devices,
    then, when a process group is up, with ``all_reduce`` (sum, sum, max).

    The reductions are isfinite-masked; a field with zero finite values
    reports mean NaN, not 0 (and max -inf).  ``x`` is a :class:`Sharded`,
    or an array, which is sharded here: a float batch that does not divide
    the mesh is NaN-padded first, any other raises.  Returns 0-d tensors
    on the host (int64, float64, float64).
    """
    if axis_name not in mesh.axis_names:
        raise ValueError(f'no mesh axis {axis_name!r} in {mesh.axis_names}')
    if not isinstance(x, Sharded):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        n0 = mesh.devices.shape[0]
        rem = int(x.shape[0]) % n0
        if rem and not np.issubdtype(x.dtype, np.floating):
            raise ValueError(
                f'batch {int(x.shape[0])} does not divide the {n0}-way mesh '
                'axis and non-float fields cannot be NaN-padded — pad to a '
                'multiple first (parallel.pad_batch)')
        if rem:
            x = np.concatenate([x, np.full((n0 - rem,) + x.shape[1:],
                                           np.nan, x.dtype)])
        x = shard_batch(x, mesh)
    cnt, tot, mx = 0.0, 0.0, -np.inf
    for shard in x.shards.values():
        if not shard.numel():
            continue
        s = shard.detach().double()
        finite = torch.isfinite(s)
        c, t, m = torch.stack([
            finite.sum().double(),
            torch.where(finite, s, 0.0).sum(),
            torch.where(finite, s, -torch.inf).max()]).tolist()
        cnt, tot, mx = cnt + c, tot + t, max(mx, m)
    if _group_up():
        on = ('cuda' if dist.get_backend() == 'nccl' else 'cpu')
        sums = torch.tensor([cnt, tot], dtype=torch.float64, device=on)
        top = torch.tensor(mx, dtype=torch.float64, device=on)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        (cnt, tot), mx = sums.tolist(), top.item()
    mean = tot / cnt if cnt > 0 else np.nan
    return (torch.tensor(int(cnt)), torch.tensor(mean, dtype=torch.float64),
            torch.tensor(mx, dtype=torch.float64))
