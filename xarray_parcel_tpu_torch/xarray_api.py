"""xarray ingest/egress: the reference-shaped Dataset interface.

Port of ``xarray_parcel_tpu.xarray_api``.  The reference is an xarray
library: every entry point takes DataArrays with a named vertical dimension
(default ``model_level_number``) and returns Datasets with
``long_name``/``units`` attrs.  This module is the boundary between that
world and the torch core: it moves the vertical dim to the trailing axis on
the host, copies the arrays to the device, runs the core function there,
copies the results back and lifts them to xarray objects with the variable
names and attrs the reference emits.

The surface mirrors the reference per function: ``lcl``,
``parcel_profile[_with_lcl]``, ``lfc_el``, ``cape_cin``, the three
parcel-variant CAPE functions, ``wet_bulb_temperature``, the scalar
diagnostics, the ops and the pipelines, under the same names with the same
``vert_dim``/``prefix`` keywords.

**The device.**  Every function here takes host data and has a
``device=None`` argument, which means the GPU (and an error where there is
none); only ``device='cpu'`` runs on the CPU.  Results are host data (numpy
inside the Dataset).

xarray is an optional dependency: when installed it is used directly; when
absent the port's own :mod:`xarray_parcel_tpu_torch.xr_lite` provides the
same Dataset/DataArray shape.

Typical use::

    import xarray_parcel_tpu_torch.xarray_api as parcel
    parcel.load_moist_adiabat_lookups()
    out = parcel.conv_properties_fused(dat)    # dat: a Dataset on the host
    proxies = parcel.storm_proxies(out)

The Dataset pipelines take ``stream_columns=`` to process a grid in column
chunks (``parallel.stream_map``) and ``mesh=`` to shard its columns over
several devices (``parallel.make_mesh``), alone or together; :func:`serve`
runs a Dataset through a deployment artifact (``deploy.export_pipeline``).
"""

import functools

import numpy as np
import torch

from . import adiabat, native
from . import api as _api
from . import cape as _cape
from . import diagnostics as _diag
from . import ops as _ops
from . import parcels as _parcels
from . import pipeline as _pipeline
from . import profile as _profile
from . import thermo as _thermo
from ._build import span
from ._device import resolve_device, to_tensor
from .adiabat import load_moist_adiabat_lookups  # noqa: F401  (re-export)
from .api import (interp1d_numba, lookup_tables_loaded,  # noqa: F401
                  moist_adiabat_lookup, moist_adiabat_tables, round_to)
from .fieldset import attrs_for
from .fused import fused_surface_cape_cin
from .lcl import lcl as _lcl
from .parallel import (pad_batch, replicate, shard_batch, sharded_map,
                       stream_map)
from .parallel.mesh import check_device_in_mesh

try:
    import xarray as xr
    HAVE_XARRAY = True
except ImportError:
    from . import xr_lite as xr
    HAVE_XARRAY = False

DEFAULT_VERT_DIM = 'model_level_number'

# Input variables that carry the vertical dim (everything else is per-column
# surface data, e.g. surface winds).
_LEVEL_VARS = ('pressure', 'temperature', 'specific_humidity', 'dewpoint',
               'height_asl', 'wind_u', 'wind_v',
               'wind_height_above_surface')
_SURFACE_VARS = ('surface_wind_u', 'surface_wind_v')


# ---------------------------------------------------------------------------
# Host <-> device
# ---------------------------------------------------------------------------

def to_device(x, device):
    """Host data to ``device``: numpy arrays (also inside dicts, lists and
    tuples) become tensors there; ``None`` and Python scalars pass."""
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    if x is None or np.isscalar(x):
        return x
    return to_tensor(x, device)


def to_host(x):
    """Tensors (also inside dicts, lists and tuples) back to numpy."""
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _resolve_tables(tables, device, dtype):
    return (tables if tables is not None
            else adiabat.default_tables(device, dtype))


def _float_dtype(arrays):
    """torch dtype of the first floating array among ``arrays`` (float32
    if there is none)."""
    for a in arrays:
        if isinstance(a, np.ndarray) and a.dtype.kind == 'f':
            return torch.from_numpy(a[:0].reshape(-1)).dtype
    return torch.float32


def _on_device(core, low, device, tables=False, **kwargs):
    """Run ``core`` on the lowered host arguments ``low`` on ``device`` and
    bring the result back to the host.  ``tables``: False (the core takes
    none), or the caller's ``tables`` argument (None: the default ones for
    the device and the arguments' dtype)."""
    device = resolve_device(device)
    if tables is not False:
        kwargs['tables'] = _resolve_tables(tables, device, _float_dtype(low))
    return to_host(core(*to_device(list(low), device), **kwargs))


# ---------------------------------------------------------------------------
# Lowering (DataArray/Dataset -> arrays) and lifting (arrays -> Dataset)
# ---------------------------------------------------------------------------

def _is_dataset(obj):
    return hasattr(obj, 'data_vars')


def _batch_dims_of(args, vert_dim):
    """Union of non-vertical dims over every dim-carrying argument, in
    first-appearance order.  Deriving them from one argument alone
    mis-lays mixed-dims inputs (e.g. a 1-D pressure coordinate variable
    next to (time, lat, lon, level) temperature)."""
    dims = []
    for a in args:
        for d in getattr(a, 'dims', ()):
            if d != vert_dim and d not in dims:
                dims.append(d)
    return tuple(dims)


def _coords_of(args, batch_dims):
    for a in args:
        if hasattr(a, 'coords'):
            return {d: a.coords[d] for d in batch_dims if d in a.coords}
    return {}


def _values(c):
    return np.asarray(c.values if hasattr(c, 'values') else c)


def _vert_coord_of(args, vert_dim):
    """Vertical index-coordinate values of the first input that carries one
    (None if no input has a vert_dim coordinate)."""
    if vert_dim is None:
        return None
    for a in args:
        if (hasattr(a, 'dims') and vert_dim in getattr(a, 'dims', ()) and
                hasattr(a, 'coords') and vert_dim in a.coords):
            return _values(a.coords[vert_dim])
    return None


def _vert_coord_values(vert_coord, size):
    """Coordinate values for a ``size``-level output.

    The reference keeps the vertical index coordinate on spliced outputs by
    shifting above-insertion indices up one, so an L+1 output of an L-level
    input spans min..max+1.  Without an input coordinate, a fresh
    0..size-1 index is attached so downstream ``.sel``/``.isel`` keep
    working.
    """
    if vert_coord is not None and len(vert_coord) == size:
        return np.asarray(vert_coord)
    if vert_coord is not None and 0 < len(vert_coord) < size:
        v = np.asarray(vert_coord)
        # Continue the coordinate's own step; non-numeric or constant
        # coordinates fall back to a fresh index.
        try:
            step = v[-1] - v[-2] if len(v) > 1 else 1
        except TypeError:
            return np.arange(size)
        if step == 0:
            return np.arange(size)
        extra = v[-1] + step * np.arange(1, size - len(v) + 1)
        return np.concatenate([v, extra])
    return np.arange(size)


def _subset_align(v, order, batch_dims):
    """Align a variable carrying only a subset of the batch dims.

    When the present dims form a suffix of ``batch_dims`` (a 1-D pressure
    coordinate variable, trailing-dim surface winds), trailing alignment
    already broadcasts it correctly against full-batch variables, so the
    array keeps its own shape.  Only when an interior (or
    leading-misaligned) batch dim is missing are size-1 axes inserted for
    the missing dims, the layout xarray's auto-broadcasting gives the
    reference."""
    order = tuple(order)
    batch_dims = tuple(batch_dims)
    if not batch_dims or order == batch_dims[len(batch_dims) - len(order):]:
        return v
    shape = tuple(v.shape[order.index(d)] if d in order else 1
                  for d in batch_dims) + v.shape[len(order):]
    return v.reshape(shape)


def _lower(a, vert_dim, batch_dims):
    """One DataArray (or array) -> ndarray, batch dims leading in the shared
    order, vertical dim trailing; subset-dim variables per
    :func:`_subset_align`."""
    if a is None or np.isscalar(a):
        return a
    if hasattr(a, 'dims'):
        order = tuple(d for d in batch_dims if d in a.dims)
        trail = (vert_dim,) if vert_dim in a.dims else ()
        a = a.transpose(*order, *trail)
        return _subset_align(np.asarray(a.values), order, batch_dims)
    return np.asarray(a)


def _lower_common(args, vert_dim, batch_dims):
    """Lower each argument, then broadcast the level-carrying ones to their
    common shape (as host views: only the 1-D pressure's own bytes exist
    until :func:`to_device` copies it): a mixed-dims call reaches the core
    functions as mutually broadcast arrays, as xarray's auto-broadcasting
    hands the reference's functions full-grid operands."""
    low = [_lower(a, vert_dim, batch_dims) for a in args]
    idx = [i for i, a in enumerate(args)
           if vert_dim is not None and hasattr(a, 'dims')
           and vert_dim in a.dims]
    if len(idx) > 1:
        tgt = np.broadcast_shapes(*(np.shape(low[i]) for i in idx))
        for i in idx:
            if np.shape(low[i]) != tgt:
                low[i] = np.broadcast_to(low[i], tgt)
    return low


def _lift(result, batch_dims, vert_dim=DEFAULT_VERT_DIM, coords=None,
          descriptions=None, vert_coord=None):
    """Dict of (batch…[, L]) arrays -> Dataset with reference attrs.

    Arrays with one more axis than the batch get ``vert_dim`` as their
    trailing dim (profile tracks) and a vertical index coordinate: the
    input's, extended by one for L+1 (LCL-spliced) outputs, or a fresh
    0..L-1 index (see :func:`_vert_coord_values`).
    """
    data_vars = {}
    vert_size = None
    for name, arr in result.items():
        arr = np.asarray(to_host(arr))
        if arr.ndim == len(batch_dims) + 1:
            dims = batch_dims + (vert_dim,)
            vert_size = arr.shape[-1]
        else:
            dims = batch_dims[:arr.ndim]
        attrs = attrs_for(name)
        if descriptions and name in descriptions:
            attrs['description'] = descriptions[name]
        data_vars[name] = (dims, arr, attrs)
    ds = xr.Dataset(data_vars)
    assign = {k: v for k, v in (coords or {}).items() if k in ds.dims}
    if vert_size is not None:
        assign[vert_dim] = _vert_coord_values(vert_coord, vert_size)
    if assign:
        ds = ds.assign_coords(assign)
    return ds


def _lift_da(arr, batch_dims, vert_dim=DEFAULT_VERT_DIM, coords=None,
             name=None, vert_coord=None):
    """One array -> DataArray (for the scalar-field entry points)."""
    arr = np.asarray(to_host(arr))
    coords = dict(coords or {})
    if arr.ndim == len(batch_dims) + 1:
        dims = batch_dims + (vert_dim,)
        coords[vert_dim] = _vert_coord_values(vert_coord, arr.shape[-1])
    else:
        dims = batch_dims[:arr.ndim]
    keep = {k: v for k, v in coords.items() if k in dims}
    return xr.DataArray(arr, dims=dims, coords=keep,
                        attrs=attrs_for(name) if name else {}, name=name)


def _rename(ds_dict, prefix, keys):
    if prefix is None:
        return ds_dict
    return {(f'{prefix}_{k}' if k in keys else k): v
            for k, v in ds_dict.items()}


def from_dataset(dat, vert_dim=DEFAULT_VERT_DIM, variables=None, mesh=None,
                 dtype=np.float32):
    """Lower a Dataset to a dict of arrays (vertical dim trailing).

    Returns ``(fields, batch_dims)`` where ``batch_dims`` is the ordered
    tuple of non-vertical dims (used by :func:`to_dataset` to lift results
    back).  Float variables are converted to ``dtype`` (float32 by
    default, through the ``native`` repacks).  Without ``mesh`` the fields
    are host (numpy) arrays, and a variable that carries only some of the
    batch dims keeps its own size (:func:`_subset_align`).  With ``mesh``
    they are ``parallel.Sharded`` over its first axis, every variable
    broadcast to the full batch first; the mesh size must then divide the
    leading batch dim, because this function returns fields at the
    input's batch shape.  The pipeline entry points
    (``conv_properties(dat, mesh=...)`` etc.) accept any grid: they pad,
    shard, compute and slice, as does streaming (``stream_columns=`` with
    ``mesh=``).  For direct use on a grid that does not divide, pad with
    ``parallel.pad_batch`` first and slice the results yourself.
    """
    names = variables or [v for v in _LEVEL_VARS + _SURFACE_VARS if v in dat]
    if not names:
        raise ValueError(
            'Dataset carries none of the recognized variables '
            f'{_LEVEL_VARS + _SURFACE_VARS}')
    # Batch dims = the union of non-vertical dims over all selected
    # variables, in first-appearance order.
    batch_dims = []
    for n in names:
        batch_dims += [d for d in dat[n].dims
                       if d != vert_dim and d not in batch_dims]
    batch_dims = tuple(batch_dims)

    dtype = np.dtype(dtype)
    fields = {}
    for name in names:
        da = dat[name]
        # Every variable is put in the same batch-dim order (variables may
        # legally carry differently ordered dims in xarray).
        order = tuple(d for d in batch_dims if d in da.dims)
        trail = (vert_dim,) if vert_dim in da.dims else ()
        if dtype != np.float32:
            v = np.ascontiguousarray(
                np.asarray(da.transpose(*order, *trail).values))
            v = v.astype(dtype, copy=False) if v.dtype.kind == 'f' else v
        elif da.dims == (vert_dim,) + order and da.ndim > 1:
            # Leading level axis -> trailing, float32, in one pass.
            v = native.levels_to_last(np.asarray(da.values))
        else:
            v = native.repack_to_f32(
                np.asarray(da.transpose(*order, *trail).values))
        fields[name] = _subset_align(v, order, batch_dims)

    if mesh is not None:
        if not batch_dims:
            raise ValueError(
                'mesh= needs at least one non-vertical (batch) dim to '
                'shard — a single-column Dataset would shard its LEVEL '
                'axis across devices')
        # Subset-dim variables must cover the full batch before the
        # leading axis is sharded, or a non-batch axis would be split.
        fields = _broadcast_fields(fields, *_batch_shape_of(
            fields, dat, batch_dims, vert_dim))
        lead = next(iter(fields.values())).shape[0]
        if lead % mesh.devices.size:
            raise ValueError(
                f'mesh size {mesh.devices.size} does not divide the leading '
                f'batch dim {lead}; the pipeline entry points '
                f'(conv_properties(dat, mesh=...)) pad automatically, or '
                f'pad via parallel.pad_batch before from_dataset')
        fields = shard_batch(fields, mesh, batch_dims=1)
    return fields, batch_dims


def _batch_shape_of(fields, dat, batch_dims, vert_dim):
    """(full batch shape, names of vert-carrying fields) for broadcasting
    subset-dim variables onto the grid."""
    sizes = {}
    for name in fields:
        for d, s in zip(dat[name].dims, dat[name].shape):
            if d != vert_dim:
                sizes[d] = int(s)
    batch_shape = tuple(sizes[d] for d in batch_dims)
    vert_names = frozenset(n for n in fields if vert_dim in dat[n].dims)
    return batch_shape, vert_names


def _broadcast_fields(fields, batch_shape, vert_names):
    """Broadcast each lowered host field onto the full batch shape (as
    zero-copy host views), so that chunking the leading axes is
    well-defined for variables that carry only some of the batch dims."""
    out = {}
    for name, v in fields.items():
        target = batch_shape + (v.shape[-1:] if name in vert_names else ())
        out[name] = v if v.shape == target else np.broadcast_to(v, target)
    return out


def _columns(fields, batch_shape, vert_names):
    """Device fields as flat columns: each expanded to the full batch shape
    on the device (a subset-dim field crossed the bus at its own size) and
    reshaped to (B, L) or (B,)."""
    out = {}
    for name, v in fields.items():
        trail = tuple(v.shape[-1:]) if name in vert_names else ()
        out[name] = v.expand(batch_shape + trail).reshape((-1,) + trail)
    return out


def _grid(out, batch_shape):
    """Flat-column outputs back at the batch shape."""
    return {k: v.reshape(batch_shape + tuple(v.shape[1:]))
            for k, v in out.items()}


def to_dataset(result, batch_dims, coords=None, vert_dim=DEFAULT_VERT_DIM):
    """Lift a dict of (batch…) arrays to a Dataset with reference attrs."""
    return _lift(result, tuple(batch_dims), vert_dim=vert_dim, coords=coords)


# ---------------------------------------------------------------------------
# Pipelines (Dataset in / Dataset out)
# ---------------------------------------------------------------------------

_PIPELINE_DOC_EXTRA = """Dataset-surface extras: ``device`` (None: the \
GPU); ``dtype``, the floating type the inputs are lowered to (float32 by \
default); ``stream_columns`` processes the grid out-of-core in chunks of \
that many columns, whose transfers overlap the compute (see \
``parallel.stream_map``); ``mesh`` shards the grid's columns over the \
mesh's devices (any grid: padded, sharded, computed and sliced), and with \
``stream_columns`` as well each chunk is sharded, so that grids larger \
than one device's memory stream through all devices.  With ``mesh`` its \
devices are where the work runs: ``device`` must be None or one of them."""


def _run_columns(core, tables, dat, vert_dim, variables, dtype,
                 stream_columns, device, mesh=None):
    """Lower ``variables`` of ``dat``, run the column program ``core``
    ((dict of (B, L)/(B,) tensors, tables) -> dict of (B, …) tensors) on
    ``device`` or over ``mesh``, whole or streamed, and lift the outputs to
    a Dataset.  ``tables``: the caller's argument (None: the default ones
    for the device and ``dtype``)."""
    if mesh is None:
        device = resolve_device(device)
        tables = _resolve_tables(tables, device, _torch_dtype(dtype))

        def run(d):
            return core(d, tables)
    else:
        check_device_in_mesh(device, mesh)
        copies = replicate(_resolve_tables(
            tables, mesh.local_devices()[0], _torch_dtype(dtype)), mesh)

        def run(d):
            return core(d, copies.on(next(iter(d.values())).device))
    with span('xparcel.dataset.lower'):
        fields, batch_dims = from_dataset(dat, vert_dim=vert_dim,
                                          variables=variables, dtype=dtype)
    if (mesh is not None or stream_columns) and not batch_dims:
        raise ValueError(
            'mesh=/stream_columns= need at least one non-vertical (batch) '
            'dim — a single-column Dataset would chunk/shard its LEVEL '
            'axis')
    batch_shape, vert_names = _batch_shape_of(fields, dat, batch_dims,
                                              vert_dim)
    if stream_columns:
        # Chunks need a real leading column axis on the host: subset-dim
        # fields are broadcast as views and copied chunk by chunk.
        fields = _broadcast_fields(fields, batch_shape, vert_names)
        out = stream_map(run, fields, batch_columns=stream_columns,
                         level_vars=tuple(vert_names), device=device,
                         mesh=mesh)
    elif mesh is not None:
        # Any grid shards: the flat column axis is padded to a mesh
        # multiple on the host (NaN rows are inert), computed sharded, and
        # the padding is sliced off again.
        fields = _broadcast_fields(fields, batch_shape, vert_names)
        flat, lead = pad_batch(
            {k: v.reshape((-1,) + v.shape[len(batch_shape):])
             for k, v in fields.items()}, mesh)
        out = _grid({k: v.numpy()[:lead]
                     for k, v in sharded_map(run, mesh)(flat).items()},
                    batch_shape)
    else:
        # Subset-dim fields cross at their own size (a 1-D pressure
        # coordinate as L floats) and are broadcast on the device.
        with span('xparcel.dataset.to_device'):
            cols = _columns(to_device(fields, device), batch_shape,
                            vert_names)
        with span('xparcel.dataset.compute'):
            out = run(cols)
        del cols                # the inputs leave the card before the copy
        with span('xparcel.dataset.to_host'):
            out = _grid(to_host(out), batch_shape)
    coords = {d: dat.coords[d] for d in batch_dims if d in dat.coords}
    with span('xparcel.dataset.lift'):
        return to_dataset(out, batch_dims, coords=coords, vert_dim=vert_dim)


def _torch_dtype(dtype):
    return torch.float64 if np.dtype(dtype).itemsize == 8 else torch.float32


def _dataset_pipeline(fn):
    @functools.wraps(fn)
    def wrapper(dat, vert_dim=DEFAULT_VERT_DIM, tables=None, mesh=None,
                stream_columns=None, device=None, dtype=np.float32,
                **kwargs):
        # The pipelines derive the dewpoint from specific humidity and
        # never read a provided 'dewpoint' variable: keep it out of the
        # ingest.
        use = [v for v in _LEVEL_VARS + _SURFACE_VARS
               if v != 'dewpoint' and v in dat]
        return _run_columns(lambda d, tab: fn(d, tables=tab, **kwargs),
                            tables, dat, vert_dim, use, dtype,
                            stream_columns, device, mesh)
    wrapper.__doc__ = ((fn.__doc__ or '').rstrip() + '\n\n' +
                       _PIPELINE_DOC_EXTRA)
    return wrapper


conv_properties = _dataset_pipeline(_pipeline.conv_properties)
conv_properties_fused = _dataset_pipeline(_pipeline.conv_properties_fused)
min_conv_properties = _dataset_pipeline(_pipeline.min_conv_properties)
min_conv_properties_fused = _dataset_pipeline(
    _pipeline.min_conv_properties_fused)


def serve(dat, artifact, vert_dim=DEFAULT_VERT_DIM, tables=None, mesh=None):
    """Run a Dataset through a deployment artifact
    (``deploy.export_pipeline`` / ``deploy.load``): Dataset in, attributed
    Dataset out, with neither a kernel build nor a table build in the
    serving process.

    ``artifact`` is a ``deploy.Deployed`` or a path to a saved one.  Any
    grid shape works: batch dims flatten to the artifact's column axis
    and the artifact streams them in chunks of its exported batch
    (sharding each chunk when it was exported with ``mesh=``; pass
    ``mesh=`` here to override the serving mesh).  The artifact's own device is where it
    runs.
    """
    from . import deploy as _deploy
    if not isinstance(artifact, _deploy.Deployed):
        artifact = _deploy.load(artifact)
    want = np.dtype(artifact.meta.get('dtype', 'float32'))
    # The artifact's inputs are the fixed pipeline contract
    # (deploy.input_spec): select exactly those variables before lowering
    # (no full-grid repack of recognized ones it does not read, like the
    # dewpoint) and fail missing ones by name.
    kept, missing, _extra = artifact.check_inputs(
        dict.fromkeys(getattr(dat, 'data_vars', dat)))
    if missing:
        raise ValueError(
            f'Dataset is missing variables the artifact requires: '
            f'{missing}')
    names = [v for v in _LEVEL_VARS + _SURFACE_VARS if v in kept]
    # Lower at the artifact's dtype: the default float32 repack would
    # round the inputs of a float64 artifact.
    fields, batch_dims = from_dataset(dat, vert_dim=vert_dim,
                                      variables=names, dtype=want)
    # A variable may carry only a subset of the batch dims (e.g.
    # time-invariant surface winds on a time+lat+lon grid): broadcast to
    # the full batch shape before flattening onto the column axis.
    batch_shape, vert_names = _batch_shape_of(fields, dat, batch_dims,
                                              vert_dim)
    fields = _broadcast_fields(fields, batch_shape, vert_names)
    flat = {k: v.reshape((-1,) + v.shape[len(batch_shape):])
            for k, v in fields.items()}
    # Tables go through unresolved: a full-table artifact loads those of
    # its recorded dtype itself.  The outputs come to the host through the
    # artifact's gatherer: an exact fit returns device tensors, sharded
    # across processes under a mesh.
    out = _grid(artifact._host(artifact(flat, tables=tables, mesh=mesh)),
                batch_shape)
    coords = {d: dat.coords[d] for d in batch_dims if d in dat.coords}
    return to_dataset(out, batch_dims, coords=coords, vert_dim=vert_dim)


def storm_proxies(conv, vert_dim=DEFAULT_VERT_DIM, device=None):
    """Storm proxies from a conv_properties Dataset."""
    needed = _pipeline.STORM_PROXY_INPUTS
    missing = [k for k in needed if k not in conv.data_vars]
    if missing:
        raise ValueError('storm_proxies needs the conv_properties output '
                         f'variables {missing}')
    # Exactly the variables the proxies read, each in the shared dim order
    # (a merged Dataset may carry extra variables and permuted dims).
    das = [conv[k] for k in needed]
    batch_dims = _batch_dims_of(das, vert_dim)
    fields = {k: _lower(conv[k], None, batch_dims) for k in needed}
    out = to_host(_pipeline.storm_proxies(
        to_device(fields, resolve_device(device))))
    coords = {d: conv.coords[d] for d in batch_dims if d in conv.coords}
    return to_dataset(out, batch_dims, coords=coords)


def valid_data(dat, vert_dim=DEFAULT_VERT_DIM, strict=True):
    """Validate the reference's input invariants on a Dataset: the vertical
    index coordinate increments by exactly 1 between levels, and pressure
    strictly decreases with level.  A host-side check.  Returns the
    per-column validity mask (all False when the coordinate itself is
    invalid); with ``strict`` raises ValueError on any violation."""
    batch_dims = _batch_dims_of([dat['pressure']], vert_dim)
    p = _lower(dat['pressure'], vert_dim, batch_dims)
    if hasattr(dat, 'coords') and vert_dim in getattr(dat, 'coords', {}):
        vert = _values(dat.coords[vert_dim])
    else:
        vert = _vert_coord_of([dat['pressure']], vert_dim)
    if vert is not None and len(vert) > 1:
        try:
            unit = bool(np.all(np.abs(np.diff(
                np.asarray(vert, dtype=float))) == 1))
        except (TypeError, ValueError):
            unit = False      # a non-numeric coord cannot be a unit index
        if not unit:
            if strict:
                raise ValueError('Index increments must all be 1.')
            return np.zeros(np.asarray(p).shape[:-1], dtype=bool)
    return _api.valid_data({'pressure': np.asarray(p)}, strict=strict)


def _fused_sb_core(d, tables=None, **kw):
    res, sol = fused_surface_cape_cin(d['pressure'], d['temperature'],
                                      d['dewpoint'], tables=tables, **kw)
    return dict(res, **sol)


def _modular_sb_core(d, tables=None, **kw):
    res, _ = _cape.surface_based_cape_cin(d['pressure'], d['temperature'],
                                          d['dewpoint'], tables=tables, **kw)
    return res


def surface_based_cape_cin_dataset(dat, vert_dim=DEFAULT_VERT_DIM,
                                   tables=None, fused=True,
                                   stream_columns=None, device=None,
                                   dtype=np.float32, **kwargs):
    """Surface-based CAPE/CIN from a Dataset with pressure / temperature /
    dewpoint variables.  With ``fused`` the fused solve is used (the CUDA
    kernel on the GPU; no profile output, LFC/EL in the result); ``kwargs``
    are the solve's options (``virtual_temperature_correction``,
    ``lcl_interp``, ``pos_cape_neg_cin``, ``post_zero_cin``) and
    ``with_lifted_index``.  ``device``, ``dtype`` and ``stream_columns`` as
    for the pipelines."""
    core = _fused_sb_core if fused else _modular_sb_core
    return _run_columns(lambda d, tab: core(d, tables=tab, **kwargs),
                        tables, dat, vert_dim,
                        ['pressure', 'temperature', 'dewpoint'], dtype,
                        stream_columns, device)


# ---------------------------------------------------------------------------
# Per-function surface (DataArray in / Dataset or DataArray out)
# ---------------------------------------------------------------------------

def _lowered(args, vert_dim, batch_args=None):
    """(lowered args, batch dims, batch coords, vertical coordinate) of a
    call's DataArray arguments; ``batch_args`` are the arguments that
    define the batch dims (default: all)."""
    batch_dims = _batch_dims_of(args if batch_args is None else batch_args,
                                vert_dim)
    low = (_lower_common(args, vert_dim, batch_dims) if vert_dim is not None
           else [_lower(a, None, batch_dims) for a in args])
    return (low, batch_dims, _coords_of(args, batch_dims),
            _vert_coord_of(args, vert_dim))


def lcl(parcel_pressure, parcel_temperature, parcel_dewpoint, device=None):
    """Lifting condensation level for parcels.  NaN inputs give NaN
    outputs."""
    low, batch_dims, coords, _ = _lowered(
        (parcel_pressure, parcel_temperature, parcel_dewpoint), None)
    return _lift(_on_device(_lcl, low, device), batch_dims, coords=coords)


def parcel_profile(pressure, parcel_pressure, parcel_temperature,
                   parcel_dewpoint, vert_dim=DEFAULT_VERT_DIM, tables=None,
                   moist_lapse=None, device=None):
    """Temperatures of a lifted parcel."""
    low, batch_dims, coords, vc = _lowered(
        (pressure, parcel_pressure, parcel_temperature, parcel_dewpoint),
        vert_dim)
    out = _on_device(_profile.parcel_profile, low, device, tables=tables,
                     moist_lapse=moist_lapse)
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def parcel_profile_with_lcl(pressure, temperature, dewpoint, parcel_pressure,
                            parcel_temperature, parcel_dewpoint,
                            vert_dim=DEFAULT_VERT_DIM, lcl_interp='log',
                            tables=None, moist_lapse=None, device=None):
    """Parcel profile including the LCL level, plus the environment tracks
    spliced at the LCL.  Output columns have L+1 levels."""
    low, batch_dims, coords, vc = _lowered(
        (pressure, temperature, dewpoint, parcel_pressure,
         parcel_temperature, parcel_dewpoint), vert_dim)
    out = _on_device(_profile.parcel_profile_with_lcl, low, device,
                     tables=tables, lcl_interp=lcl_interp,
                     moist_lapse=moist_lapse)
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def lfc_el(pressure, parcel_temperature, temperature, lcl_pressure,
           lcl_temperature, vert_dim=DEFAULT_VERT_DIM, device=None):
    """Level of free convection and equilibrium level."""
    low, batch_dims, coords, _ = _lowered(
        (pressure, parcel_temperature, temperature, lcl_pressure,
         lcl_temperature), vert_dim)
    return _lift(_on_device(_api.lfc_el, low, device), batch_dims,
                 coords=coords)


def cape_cin(pressure, temperature, dewpoint, parcel_temperature,
             parcel_pressure, parcel_dewpoint, vert_dim=DEFAULT_VERT_DIM,
             tables=None, device=None, **kwargs):
    """CAPE/CIN for an arbitrary parcel; returns (Dataset, profile
    Dataset)."""
    low, batch_dims, coords, vc = _lowered(
        (pressure, temperature, dewpoint, parcel_temperature,
         parcel_pressure, parcel_dewpoint), vert_dim)
    res, profile = _on_device(_cape.cape_cin, low, device, tables=tables,
                              **kwargs)
    return (_lift(res, batch_dims, coords=coords),
            _lift(profile, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=vc))


def _cape_variant(core, res_extras):
    """Shared wrapper for the three parcel-choice CAPE entry points."""
    def wrapper(pressure, temperature, dewpoint,
                vert_dim=DEFAULT_VERT_DIM, prefix=None, tables=None,
                device=None, **kwargs):
        if _is_dataset(pressure):
            raise TypeError(
                'pass pressure/temperature/dewpoint DataArrays (the '
                'reference signature); for Dataset-level pipelines use '
                'conv_properties / surface_based_cape_cin_dataset')
        low, batch_dims, coords, vc = _lowered(
            (pressure, temperature, dewpoint), vert_dim)
        res, *rest = _on_device(core, low, device, tables=tables, **kwargs)
        desc = res_extras(kwargs)
        if prefix and desc:
            # _lift matches descriptions against the renamed keys.
            desc = {f'{prefix}_{k}': v for k, v in desc.items()}
        res = _lift(_rename(res, prefix, ('cape', 'cin')), batch_dims,
                    coords=coords, descriptions=desc)
        return (res,) + tuple(
            _lift(r, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=vc) for r in rest)
    return wrapper


surface_based_cape_cin = _cape_variant(
    _cape.surface_based_cape_cin,
    lambda kw: {'cape': 'CAPE for surface-based parcel.',
                'cin': 'CIN for surface-based parcel.'})
surface_based_cape_cin.__doc__ = (
    'Surface-based CAPE and CIN; returns (Dataset, profile Dataset).')


def _mu_desc(kwargs):
    depth = kwargs.get('depth', 300)
    d = f'most-unstable parcel in lowest {depth} hPa.'
    return {'cape': f'CAPE for {d}', 'cin': f'CIN for {d}'}


def _ml_desc(kwargs):
    depth = kwargs.get('depth', 100)
    d = f'fully-mixed lowest {depth} hPa parcel'
    return {'cape': f'CAPE for {d}.', 'cin': f'CIN for {d}'}


most_unstable_cape_cin = _cape_variant(_parcels.most_unstable_cape_cin,
                                       _mu_desc)
most_unstable_cape_cin.__doc__ = (
    'Most-unstable-parcel CAPE/CIN; returns (Dataset, profile Dataset, '
    'parcel Dataset).')

mixed_layer_cape_cin = _cape_variant(_parcels.mixed_layer_cape_cin, _ml_desc)
mixed_layer_cape_cin.__doc__ = (
    'Fully-mixed-layer CAPE/CIN; returns (Dataset, profile Dataset, parcel '
    'Dataset).')


def lifted_index(profile, vert_dim=DEFAULT_VERT_DIM, description=None,
                 prefix=None, device=None):
    """Galway lifted index from a parcel_profile_with_lcl Dataset."""
    batch_dims = tuple(d for d in profile['pressure'].dims if d != vert_dim)
    keys = ('pressure', 'temperature', 'environment_temperature')
    low = [_lower(profile[k], vert_dim, batch_dims) for k in keys]
    out = _on_device(lambda *x: _diag.lifted_index(dict(zip(keys, x))), low,
                     device)
    out = _rename(out, prefix, ('lifted_index',))
    key = f'{prefix}_lifted_index' if prefix else 'lifted_index'
    desc = {key: description} if description else None
    coords = _coords_of([profile[k] for k in profile.data_vars], batch_dims)
    return _lift(out, batch_dims, coords=coords, descriptions=desc)


def deep_convective_index(pressure, temperature, dewpoint, lifted_index,
                          vert_dim=DEFAULT_VERT_DIM, prefix=None,
                          description=None, device=None):
    """Kunz DCI."""
    low, batch_dims, coords, _ = _lowered(
        (pressure, temperature, dewpoint, lifted_index), vert_dim)
    out = _rename(_on_device(_diag.deep_convective_index, low, device),
                  prefix, ('dci',))
    key = f'{prefix}_dci' if prefix else 'dci'
    desc = {key: description} if description else None
    return _lift(out, batch_dims, coords=coords, descriptions=desc)


def wet_bulb_temperature(pressure, temperature, dewpoint,
                         vert_dim=DEFAULT_VERT_DIM, tables=None,
                         moist_lapse=None, device=None):
    """Exact wet-bulb temperature (vectorised Normand's rule)."""
    low, batch_dims, coords, vc = _lowered((pressure, temperature, dewpoint),
                                           vert_dim)
    out = _on_device(_diag.wet_bulb_temperature, low, device, tables=tables,
                     moist_lapse=moist_lapse)
    return _lift_da(out, batch_dims, vert_dim=vert_dim, coords=coords,
                    name='wet_bulb_temperature', vert_coord=vc)


def wet_bulb_temperature_fast(temperature, dewpoint, device=None):
    """Knox (2017) one-third-rule wet bulb."""
    low, batch_dims, coords, _ = _lowered((temperature, dewpoint), None)
    return _lift_da(_on_device(_thermo.wet_bulb_temperature_fast, low,
                               device),
                    batch_dims, coords=coords, name='wet_bulb_temperature')


def lapse_rate(pressure, temperature, height, from_pressure=700.0,
               to_pressure=500.0, vert_dim=DEFAULT_VERT_DIM, device=None):
    """Lapse rate between two pressure levels; the output's name follows
    the layer computed (``lapse_rate_700_500`` at the defaults)."""
    low, batch_dims, coords, _ = _lowered((pressure, temperature, height),
                                          vert_dim)
    out = _on_device(_diag.lapse_rate, low, device,
                     from_pressure=float(from_pressure),
                     to_pressure=float(to_pressure))
    return _lift_da(out, batch_dims, coords=coords,
                    name=f'lapse_rate_{from_pressure:g}_{to_pressure:g}')


def isobar_temperature(pressure, temperature, isobar,
                       vert_dim=DEFAULT_VERT_DIM, device=None):
    """Temperature at a pressure level; the output's name follows the
    isobar (``temp_500``)."""
    low, batch_dims, coords, _ = _lowered((pressure, temperature), vert_dim)
    out = _on_device(_diag.isobar_temperature, low, device,
                     isobar=float(isobar))
    return _lift_da(out, batch_dims, coords=coords, name=f'temp_{isobar:g}')


def freezing_level_height(temperature, height, vert_dim=DEFAULT_VERT_DIM,
                          device=None):
    """Height of the 0 C dry-bulb isotherm."""
    low, batch_dims, coords, _ = _lowered((temperature, height), vert_dim)
    return _lift_da(_on_device(_diag.freezing_level_height, low, device),
                    batch_dims, coords=coords, name='freezing_level')


def melting_level_height(pressure, temperature, dewpoint, height, fast=True,
                         vert_dim=DEFAULT_VERT_DIM, tables=None,
                         device=None):
    """Height of the 0 C wet-bulb isotherm."""
    low, batch_dims, coords, _ = _lowered(
        (pressure, temperature, dewpoint, height), vert_dim)
    mlh, _ = _on_device(_diag.melting_level_height, low, device,
                        tables=tables, fast=bool(fast))
    return _lift_da(mlh, batch_dims, coords=coords, name='melting_level')


def wind_shear(surface_wind_u, surface_wind_v, wind_u, wind_v, height,
               shear_height=6000.0, vert_dim=DEFAULT_VERT_DIM, device=None):
    """Bulk wind shear to ``shear_height``."""
    low, batch_dims, coords, _ = _lowered(
        (surface_wind_u, surface_wind_v, wind_u, wind_v, height), vert_dim)
    out = _on_device(_diag.wind_shear, low, device,
                     shear_height=float(shear_height))
    return _lift(out, batch_dims, coords=coords)


def significant_hail_parameter(mucape, mixing_ratio, lapse, temp_500, shear,
                               flh, device=None):
    """SPC significant hail parameter."""
    low, batch_dims, coords, _ = _lowered(
        (mucape, mixing_ratio, lapse, temp_500, shear, flh), None)
    return _lift_da(_on_device(_diag.significant_hail_parameter, low,
                               device),
                    batch_dims, coords=coords, name='ship')


def dry_lapse(pressure, parcel_temperature, parcel_pressure=None,
              vert_dim=DEFAULT_VERT_DIM, device=None):
    """Dry adiabat along a column."""
    low, batch_dims, coords, vc = _lowered(
        (pressure, parcel_temperature, parcel_pressure), vert_dim)
    return _lift_da(_on_device(_api.dry_lapse, low, device), batch_dims,
                    vert_dim=vert_dim, coords=coords, name='temperature',
                    vert_coord=vc)


def moist_lapse(pressure, parcel_temperature, parcel_pressure=None,
                vert_dim=DEFAULT_VERT_DIM, tables=None, device=None):
    """Moist adiabat along a column via the spectral table consumer."""
    low, batch_dims, coords, vc = _lowered(
        (pressure, parcel_temperature, parcel_pressure), vert_dim)
    out = _on_device(adiabat.moist_lapse, low, device, tables=tables)
    return _lift_da(out, batch_dims, vert_dim=vert_dim, coords=coords,
                    name='temperature', vert_coord=vc)


def mixing_ratio(temperature, dewpoint, pressure, device=None):
    """Mixing ratio via the reference's RH route."""
    low, batch_dims, coords, _ = _lowered((temperature, dewpoint, pressure),
                                          None)
    return _lift_da(_on_device(_thermo.mixing_ratio, low, device),
                    batch_dims, coords=coords, name='mixing_ratio')


def dewpoint_from_specific_humidity(pressure, temperature, specific_humidity,
                                    vert_dim=DEFAULT_VERT_DIM, device=None):
    """Dewpoint from specific humidity via the reference's RH chain, the
    derivation the pipelines use internally."""
    low, batch_dims, coords, vc = _lowered(
        (pressure, temperature, specific_humidity), vert_dim)
    out = _on_device(_thermo.dewpoint_from_specific_humidity, low, device)
    return _lift_da(out, batch_dims, vert_dim=vert_dim, coords=coords,
                    name='dewpoint', vert_coord=vc)


def dewpoint_from_relative_humidity(temperature, relative_humidity,
                                    vert_dim=DEFAULT_VERT_DIM, device=None):
    """Dewpoint from relative humidity (Bolton inverted at e = RH e_s(T))."""
    low, batch_dims, coords, vc = _lowered((temperature, relative_humidity),
                                           vert_dim)
    out = _on_device(_thermo.dewpoint_from_relative_humidity, low, device)
    return _lift_da(out, batch_dims, vert_dim=vert_dim, coords=coords,
                    name='dewpoint', vert_coord=vc)


def virtual_temperature(temperature, mixing_ratio, epsilon=0.608,
                        device=None):
    """Doswell-Rasmussen virtual temperature."""
    low, batch_dims, coords, _ = _lowered((temperature, mixing_ratio), None)
    out = _on_device(_thermo.virtual_temperature, low, device,
                     epsilon=float(epsilon))
    return _lift_da(out, batch_dims, coords=coords,
                    name='virtual_temperature')


# ---------------------------------------------------------------------------
# Ops-level surface: the reference exposes all its building blocks as xarray
# functions, so that custom diagnostics can be composed from DataArrays.
# ---------------------------------------------------------------------------

def _fields_of(dat, vert_dim, names=None):
    """Dataset/dict of DataArrays -> (fields dict, batch_dims, vert_coord,
    coords).

    Without ``names``, Dataset input is subset to the variables that carry
    ``vert_dim``: surface variables riding along in the same Dataset
    (winds, ids, masks) are not part of a vertical-column op."""
    if _is_dataset(dat):
        if names is None:
            names = [k for k in dat.data_vars
                     if vert_dim in getattr(dat[k], 'dims', ())]
            if not names:
                raise ValueError(
                    f'no data variable carries the vertical dim '
                    f'{vert_dim!r}; pass names= to select variables '
                    f'explicitly or vert_dim= to name the level dimension')
        das = {k: dat[k] for k in names}
    else:
        das = (dict(dat) if names is None
               else {k: dat[k] for k in names})
    args = list(das.values())
    batch_dims = _batch_dims_of(args, vert_dim)
    fields = dict(zip(das, _lower_common(args, vert_dim, batch_dims)))
    vc = _vert_coord_of(args, vert_dim)
    coords = _coords_of(args, batch_dims)
    if _is_dataset(dat):
        # Dataset-level coords (xr_lite keeps them only on the Dataset).
        ds_coords = getattr(dat, 'coords', {})
        if vc is None and vert_dim in ds_coords:
            vc = _values(ds_coords[vert_dim])
        for d in batch_dims:
            if d not in coords and d in ds_coords:
                coords[d] = ds_coords[d]
    return fields, batch_dims, vc, coords


def _all_names(dat):
    return list(dat.data_vars) if _is_dataset(dat) else list(dict(dat))


def get_layer(dat, depth=100.0, interpolate=True,
              vert_dim=DEFAULT_VERT_DIM, names=None, device=None):
    """Surface-based layer of the given pressure depth; with ``interpolate``
    the layer top is added as a new level (L+1 output).
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, vc, coords = _fields_of(dat, vert_dim, names=names)
    out = _on_device(_ops.get_layer, [fields], device, depth=float(depth),
                     interpolate=bool(interpolate))
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def mixed_layer(dat, depth=100.0, vert_dim=DEFAULT_VERT_DIM, names=None,
                device=None):
    """Mass-weighted layer means of every non-pressure level variable.
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, _, coords = _fields_of(dat, vert_dim, names=names)
    out = _on_device(_parcels.mixed_layer, [fields], device,
                     depth=float(depth))
    return _lift(out, batch_dims, coords=coords)


def mixed_parcel(pressure, temperature, dewpoint, depth=100.0,
                 vert_dim=DEFAULT_VERT_DIM, device=None):
    """Fully-mixed surface-layer parcel state."""
    low, batch_dims, coords, _ = _lowered((pressure, temperature, dewpoint),
                                          vert_dim)
    out = _on_device(_parcels.mixed_parcel, low, device, depth=float(depth))
    return _lift(out, batch_dims, coords=coords)


def most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0,
                         vert_dim=DEFAULT_VERT_DIM, device=None):
    """The max-theta-e parcel in the surface layer."""
    low, batch_dims, coords, _ = _lowered((pressure, temperature, dewpoint),
                                          vert_dim)
    out = _on_device(_parcels.most_unstable_parcel, low, device,
                     depth=float(depth))
    return _lift(out, batch_dims, coords=coords)


def insert_level(dat, level, coord='pressure', vert_dim=DEFAULT_VERT_DIM,
                 names=None, device=None):
    """Splice a per-column level into pressure-sorted profiles; the output
    has L+1 levels and keeps a vertical index coordinate as the reference's
    reindexing does.
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, vc, coords = _fields_of(dat, vert_dim, names=names)
    lvl = {k: _lower(v, None, batch_dims) for k, v in
           (level.data_vars.items() if _is_dataset(level)
            else dict(level).items())}
    out = _on_device(_ops.insert_level, [fields, lvl], device, coord=coord)
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def find_intersections(x, a, b, log_x=False, vert_dim=DEFAULT_VERT_DIM,
                       device=None):
    """Crossings of two curves sharing coordinates; entry k describes the
    crossing in gap (k, k+1), NaN where none."""
    low, batch_dims, coords, _ = _lowered((x, a, b), vert_dim)
    out = _on_device(_ops.find_intersections, low, device, log_x=bool(log_x))
    out = {k: v for k, v in out.items() if k != 'all_logx'}
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords)


def trapz(y, x, vert_dim=DEFAULT_VERT_DIM, device=None):
    """NaN-skipping trapezoidal integral along the vertical dim."""
    low, batch_dims, coords, _ = _lowered((y, x), vert_dim)
    return _lift_da(_on_device(_ops.trapz, low, device), batch_dims,
                    coords=coords, name='trapz')


def linear_interp(x, coords, at, extrapolate=False,
                  vert_dim=DEFAULT_VERT_DIM, device=None):
    """Duplicate-aware linear interpolation at a per-column target."""
    low, batch_dims, batch_coords, _ = _lowered((x, coords, at), vert_dim,
                                                batch_args=(x, coords))
    out = _on_device(_ops.linear_interp, low, device,
                     extrapolate=bool(extrapolate))
    return _lift_da(out, batch_dims, coords=batch_coords, name=None)


def log_interp(x, coords, at, extrapolate=False, vert_dim=DEFAULT_VERT_DIM,
               device=None):
    """``linear_interp`` on log-transformed coordinates."""
    low, batch_dims, batch_coords, _ = _lowered((x, coords, at), vert_dim,
                                                batch_args=(x, coords))
    out = _on_device(_ops.log_interp, low, device,
                     extrapolate=bool(extrapolate))
    return _lift_da(out, batch_dims, coords=batch_coords, name=None)


def shift_out_nans(dat, key='pressure', vert_dim=DEFAULT_VERT_DIM,
                   names=None, device=None):
    """Shift columns left over their leading NaNs (the reference's
    compaction loop; the pipelines use first-valid-index semantics
    instead).
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, vc, coords = _fields_of(dat, vert_dim, names=names)
    out = _on_device(_ops.compact_left, [fields], device, key=key)
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def bound_pressure(pressure, bound, vert_dim=DEFAULT_VERT_DIM, device=None):
    """Closest pressure level to ``bound``; ties take the larger
    pressure."""
    low, batch_dims, coords, _ = _lowered((pressure, bound), vert_dim,
                                          batch_args=(pressure,))

    def core(p, b):
        return _ops.bound_pressure(p, _ops.tensor_like(b, p))

    return _lift_da(_on_device(core, low, device), batch_dims,
                    coords=coords, name='bound_pressure')


def trap_around_zeros(x, y, log_x=True, start=0,
                      vert_dim=DEFAULT_VERT_DIM, device=None):
    """Rectangle areas hugging each zero crossing of ``y`` along ``x``;
    returns (areas Dataset over a fresh gap index, gap-mask DataArray)."""
    low, batch_dims, coords, _ = _lowered((x, y), vert_dim)
    areas, gap_mask = _on_device(_api.trap_around_zeros, low, device,
                                 log_x=bool(log_x), start=int(start))
    return (_lift(areas, batch_dims, vert_dim=vert_dim, coords=coords),
            _lift_da(gap_mask, batch_dims, coords=coords, name='gap_mask',
                     vert_dim=vert_dim))


def cape_cin_base(pressure, temperature, lfc_pressure, el_pressure,
                  parcel_temperature, vert_dim=DEFAULT_VERT_DIM,
                  pos_cape_neg_cin=True, post_zero_cin=False, device=None):
    """CAPE/CIN from a parcel track and LFC/EL pressures."""
    low, batch_dims, coords, _ = _lowered(
        (pressure, temperature, lfc_pressure, el_pressure,
         parcel_temperature), vert_dim)
    out = _on_device(_api.cape_cin_base, low, device,
                     pos_cape_neg_cin=bool(pos_cape_neg_cin),
                     post_zero_cin=bool(post_zero_cin))
    return _lift(out, batch_dims, coords=coords)


def add_lcl_to_profile(profile, environment=None, interpolator='log',
                       vert_dim=DEFAULT_VERT_DIM, device=None):
    """Splice the profile's LCL into its level tracks (L+1 output),
    optionally interpolating environment tracks at the LCL."""
    prof_fields, batch_dims, vc, coords = _fields_of(
        profile, vert_dim, names=_all_names(profile))
    env_fields = None
    if environment is not None:
        env_fields, _, _, _ = _fields_of(environment, vert_dim,
                                         names=_all_names(environment))
    out = _on_device(
        lambda p, e: _profile.add_lcl_to_profile(
            p, environment=e, interpolator=interpolator),
        [prof_fields, env_fields], device)
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def from_most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0,
                              vert_dim=DEFAULT_VERT_DIM, device=None):
    """Columns masked to levels at/above the most unstable parcel, plus the
    parcel; returns (fields Dataset, parcel Dataset)."""
    low, batch_dims, coords, vc = _lowered((pressure, temperature, dewpoint),
                                           vert_dim)
    fields, parcel = _on_device(_parcels.from_most_unstable_parcel, low,
                                device, depth=float(depth))
    return (_lift(fields, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=vc),
            _lift(parcel, batch_dims, coords=coords))


def mix_layer(pressure, temperature, dewpoint, depth=100.0,
              vert_dim=DEFAULT_VERT_DIM, device=None):
    """Columns with the lowest ``depth`` hPa replaced by the fully-mixed
    parcel as a spliced bottom level (L+1 output); returns
    (fields Dataset, parcel Dataset)."""
    low, batch_dims, coords, vc = _lowered((pressure, temperature, dewpoint),
                                           vert_dim)
    fields, parcel = _on_device(_parcels.mix_layer, low, device,
                                depth=float(depth))
    return (_lift(fields, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=vc),
            _lift(parcel, batch_dims, coords=coords))
