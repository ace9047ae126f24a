"""Deployment artifacts: export a pipeline once, serve it anywhere.

Port of ``xarray_parcel_tpu.deploy``.  The JAX artifact removes tracing,
lowering and compiling from the serving process.  Eager PyTorch has none of
these; what a fresh process of the port pays before its first batch is the
``nvcc`` build of the kernel library and the build of the adiabat tables.
So the artifact is a zip that takes both away:

- ``meta.json``: the pipeline's name, the exported batch, levels and
  dtype, slim or full, the table dtypes, the mesh shape, the keyword
  arguments, the torch version, the exporting device's type and the hash
  of the kernel sources;
- ``tables.npz``: the spectral coefficients (a few MB) when the artifact
  is *slim*, which is the default for every pipeline that reads nothing
  else: the serving process then needs no table cache, no table build and
  no ``tables=`` argument;
- ``kernels.so``: the built kernel library, when the export ran on a
  machine with the card.  :func:`load` puts it where ``_build`` looks for
  it if that file is absent and the recorded hash equals this tree's, so
  that a fresh serving process needs no ``nvcc``.  Another hash is no
  error: the library is then built as usual.

:func:`load` returns a :class:`Deployed` callable.  Fixed-batch artifacts
serve any grid size: inputs stream through in chunks of the exported batch,
the last padded (NaN for floats, which the pipelines turn into NaN outputs)
and sliced back (``parallel.stream_map``).

What differs from the JAX module, on purpose:

- **No program is stored**, so keyword arguments cannot be closed over in
  one.  They are stored in ``meta.json`` as JSON values and applied at
  every call; a value JSON cannot hold raises at export.  A registry
  pipeline is stored by name, a custom callable as ``module:qualname``,
  and :meth:`Deployed.save` raises if that cannot be imported back.
  ``torch.export`` and AOTInductor are not used: the kernels are launched
  through ``ctypes``, which neither can trace.
- **Slim or full** is found by a probe, there being no traced program to
  eliminate dead code from: the pipeline runs once on 8 columns on the CPU
  with tables that hold the coefficients only, and the error of a table
  mode that misses ``curves``/``lookup`` means "reads the full tables".
- **``polymorphic=True``** stores ``batch: null`` and runs any batch
  whole.  The CUDA kernels take any batch, so the fused pipelines export
  this way too; with ``mesh`` it still raises.
- **float64** needs no process-wide switch: a float64 artifact serves in a
  default process.
- **Mesh artifacts** keep their contract though no sharding is baked in:
  the batch divides the mesh's first axis, a mesh passed to a non-mesh
  artifact raises, a serving mesh of another shape raises, and the default
  serving mesh is built from the recorded shape when the device count
  fits.
- There is no compile cache to enable, and ``device`` (None: the GPU)
  stands where the JAX module has ``platforms``.
"""

import importlib
import io
import json
import os
import types
import zipfile

import numpy as np
import torch

from . import _build, adiabat, pipeline
from ._device import resolve_device, to_tensor
from .parallel import (Sharded, make_mesh, replicate, sharded_map,
                       stream_map)
from .parallel.chunked import _map_leaves
from .parallel.mesh import check_device_in_mesh

_FORMAT = 'xarray-parcel-tpu-torch-exported-v1'
#: Artifacts whose tables are not the classic three arrays (slim: the
#: coefficients alone, embedded; spectral-less: curves and lookup) are
#: written as v2, so that a loader that knows only v1 fails on the format.
_FORMAT_SLIM = 'xarray-parcel-tpu-torch-exported-v2'
_FORMATS_READ = frozenset({_FORMAT, _FORMAT_SLIM})
_FORMATS_JAX = frozenset({'xarray-parcel-tpu-exported-v1',
                          'xarray-parcel-tpu-exported-v2'})
_LIBRARY = 'kernels.so'


def _with_proxies(base):
    def fn(dat, tables=None, **kwargs):
        out = dict(base(dat, tables=tables, **kwargs))
        out.update(pipeline.storm_proxies(out))
        return out
    fn.__name__ = base.__name__ + '_with_proxies'
    return fn


#: Exportable named pipelines (dict-in / dict-out, ``tables=`` kwarg).
#: The ``_with_proxies`` forms append the 8 storm-proxy booleans + SHIP,
#: the reference demo's full output set.
PIPELINES = {
    'conv_properties': pipeline.conv_properties,
    'conv_properties_fused': pipeline.conv_properties_fused,
    'min_conv_properties': pipeline.min_conv_properties,
    'min_conv_properties_fused': pipeline.min_conv_properties_fused,
    'conv_properties_with_proxies': _with_proxies(pipeline.conv_properties),
    'conv_properties_fused_with_proxies':
        _with_proxies(pipeline.conv_properties_fused),
}


def _np_dtype(dtype):
    """numpy float32 or float64 for a numpy, torch or named dtype."""
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f'pipelines run in float32 or float64, not {dtype}')
    return dtype


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def input_spec(batch, levels=90, wind_levels=None, dtype=np.float32):
    """``{name: (shape, dtype name)}`` of the pipelines' input contract
    (the reference's variable names).  ``batch`` may be None for a batch
    of any size."""
    lw = levels if wind_levels is None else wind_levels
    name = _np_dtype(dtype).name

    def s(*shape):
        return shape, name
    return {
        'pressure': s(batch, levels),
        'temperature': s(batch, levels),
        'specific_humidity': s(batch, levels),
        'height_asl': s(batch, levels),
        'surface_wind_u': s(batch),
        'surface_wind_v': s(batch),
        'wind_u': s(batch, lw),
        'wind_v': s(batch, lw),
        'wind_height_above_surface': s(batch, lw),
    }


def _tables_or_load(tables, dtype=None, device=None, full=False):
    """The caller's tables, else the default ones for ``device`` and
    ``dtype`` (those ``load_moist_adiabat_lookups`` loaded, else the
    coefficients alone); with ``full``, defaults that lack curves and
    lookup are loaded from the cache, or built and cached, as in a fresh
    serving process.

    ``dtype`` is the table dtype the artifact was exported with, not the
    serving process's default.
    """
    if tables is not None:
        return tables
    dtype = _torch_dtype(dtype or 'float32')
    if full and adiabat._LOADED is None:
        # Nothing loaded yet: load (or build) the full tables once, not the
        # coefficients first only to set them aside.
        return adiabat.load_moist_adiabat_lookups(dtype=dtype, device=device)
    tables = adiabat.default_tables(device, dtype)
    if full and tables.curves is None:
        tables = adiabat.load_moist_adiabat_lookups(dtype=dtype,
                                                    device=device)
    return tables


def _probe_columns(levels, wind_levels, dtype):
    """Eight plausible columns on the CPU in the input contract's layout,
    for the slim probe."""
    p = np.linspace(1000.0, 150.0, levels)
    t = 300.0 - 75.0 * (1.0 - (p / 1000.0) ** 0.28)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    hw = np.linspace(0.0, 12000.0, wind_levels)
    fields = {
        'pressure': p, 'temperature': t,
        'specific_humidity': 0.012 * (p / 1000.0) ** 3, 'height_asl': h,
        'surface_wind_u': np.float64(3.0), 'surface_wind_v': np.float64(0.0),
        'wind_u': 8.0 + 0.0 * hw, 'wind_v': 2.0 + 0.0 * hw,
        'wind_height_above_surface': hw}
    return {k: torch.as_tensor(np.broadcast_to(v, (8,) + np.shape(v)).copy(),
                               dtype=_torch_dtype(dtype))
            for k, v in fields.items()}


def _used_tables(fn, levels, wind_levels, dtype, coeffs, kwargs):
    """Which of the big table arrays the pipeline reads: it runs once on
    8 columns on the CPU with tables that hold the coefficients only, and
    the table mode that then misses its array names it.  (The first one
    missed ends the run, so at most one is named.)"""
    probe = adiabat.AdiabatTables(
        torch.as_tensor(np.asarray(coeffs)).to(_torch_dtype(dtype)))
    try:
        with torch.no_grad():
            fn(_probe_columns(levels, wind_levels, dtype), tables=probe,
               **kwargs)
    except adiabat.MissingTableError as e:
        return {e.table}
    return set()


def _host_array(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pipeline_name(name):
    """What ``meta.json`` stores for a registry name or a callable."""
    if isinstance(name, str):
        if name not in PIPELINES:
            raise ValueError(f'unknown pipeline {name!r}; the registry has '
                             f'{sorted(PIPELINES)}')
        return name
    return (f"{getattr(name, '__module__', '?')}:"
            f"{getattr(name, '__qualname__', 'custom')}")


def _resolve_pipeline(stored):
    """The callable for a stored name: a registry entry, or
    ``module:qualname`` imported."""
    if stored in PIPELINES:
        return PIPELINES[stored]
    module, _, qualname = stored.partition(':')
    try:
        fn = importlib.import_module(module)
        for part in qualname.split('.'):
            fn = getattr(fn, part)
    except (ImportError, AttributeError, ValueError) as e:
        raise ValueError(
            f'the pipeline {stored!r} is neither in the registry '
            f'({sorted(PIPELINES)}) nor importable as module:qualname') from e
    return fn


def export_pipeline(name, batch, levels=90, wind_levels=None,
                    dtype=np.float32, tables=None, polymorphic=False,
                    device=None, mesh=None, path=None, slim=None,
                    **kwargs):
    """Export a named pipeline (or any dict -> dict callable taking a
    ``tables=`` kwarg) at a fixed input shape; returns a :class:`Deployed`.

    ``batch`` is the exported batch size; a fixed-batch artifact still
    serves any grid (see :class:`Deployed`).  ``polymorphic=True`` stores
    no batch: every call then runs its batch whole.  ``mesh`` exports for
    a mesh: the batch is sharded over its first axis
    (``parallel.batch_spec`` layout), the tables are replicated, and
    serving needs a mesh of the same shape (see :meth:`Deployed.__call__`).
    ``kwargs`` are stored with the artifact and applied at every call
    (e.g. ``ignore_nans=True``); they must be JSON values.  ``tables``
    defaults to the default tables of the device.  ``device`` (None: the
    GPU) is where the returned artifact runs; with ``mesh`` the mesh's
    devices are.

    ``slim`` controls whether the spectral coefficients (a few MB) are
    embedded so the artifact is fully standalone (see the module
    docstring).  Default ``None`` = auto: slim whenever the pipeline
    reads only ``tables.coeffs`` (true for every registry pipeline),
    full-table otherwise.  ``True`` forces slim and raises if the
    pipeline reads the curves/lookup arrays; ``False`` forces the
    full-table artifact (tables stay arguments of every call; only their
    dtypes enter the artifact).
    """
    fn = PIPELINES[_pipeline_name(name)] if isinstance(name, str) else name
    if polymorphic and mesh is not None:
        raise ValueError('polymorphic batch and mesh sharding do not '
                         'compose — export a fixed sharded batch')
    if mesh is None:
        device = resolve_device(device)
    else:
        check_device_in_mesh(device, mesh)
        device = mesh.local_devices()[0]
    dtype = _np_dtype(dtype)
    lw = int(levels if wind_levels is None else wind_levels)
    try:
        json.dumps(kwargs)
    except (TypeError, ValueError) as e:
        raise ValueError(
            'keyword arguments are stored in the artifact\'s meta.json and '
            f'applied at every call, so they must be JSON values: {e}'
        ) from e
    tables = _tables_or_load(tables, dtype, device)

    if slim is None or slim:
        if getattr(tables, 'coeffs', None) is None:
            # Tables without coefficients: slim needs them, the full-table
            # export below does not.
            if slim:
                raise ValueError(
                    'slim=True needs spectral coefficients but '
                    'tables.coeffs is None — rebuild with '
                    'load_moist_adiabat_lookups()')
            big = ['coeffs is None — rebuild the tables']
        else:
            try:
                big = sorted(_used_tables(fn, int(levels), lw, dtype,
                                          _host_array(tables.coeffs),
                                          kwargs))
            except Exception:
                if slim:
                    raise
                big = ['<usage probe failed>']
            if big and slim:
                raise ValueError(
                    'slim=True needs a coefficients-only pipeline, but '
                    f'this one reads the full table arrays {big} (e.g. '
                    "index_mode='bilinear'/'nearest' or pointwise "
                    'moist_lapse) — export with slim=False')
        slim = not big

    if slim:
        tab_arrays = (tables.coeffs,)
    else:
        # Full-table artifact: the tables are arguments of every call.
        # Tables without coefficients export two leaves.
        n_tab = 2 if getattr(tables, 'coeffs', None) is None else 3
        tab_arrays = (tables.curves, tables.lookup, tables.coeffs)[:n_tab]
        missing = [n for n, a in zip(('curves', 'lookup'), tab_arrays)
                   if a is None]
        if missing:
            raise ValueError(
                f'a full-table artifact needs tables with {missing}: call '
                'load_moist_adiabat_lookups() or pass tables=')

    if polymorphic:
        batch = None
    elif batch is None:
        raise ValueError('batch=None needs polymorphic=True (or pass the '
                         'static batch size to export)')
    elif int(batch) < 1:
        raise ValueError(f'exported batch must be >= 1, got {batch}')
    # batch_spec shards the batch over the first mesh axis only.
    if mesh is not None and int(batch) % int(mesh.devices.shape[0]):
        raise ValueError(f'batch {batch} must divide evenly over the '
                         f'{int(mesh.devices.shape[0])}-way batch axis of '
                         'the mesh (Deployed pads any real grid onto it)')

    def dtype_name(a):
        return _host_array(a[:0]).dtype.name

    library = None
    if device.type == 'cuda':
        with open(_build.build()[0], 'rb') as f:
            library = f.read()
    meta = {
        'format': _FORMAT if len(tab_arrays) == 3 else _FORMAT_SLIM,
        'pipeline': _pipeline_name(name),
        'batch': None if polymorphic else int(batch),
        'polymorphic': bool(polymorphic),
        'levels': int(levels),
        'wind_levels': lw,
        'dtype': dtype.name,
        'slim': bool(slim),
        'table_dtype': dtype_name(tab_arrays[0]),
        'table_dtypes': [dtype_name(a) for a in tab_arrays],
        'platforms': [device.type],
        'mesh': None if mesh is None else {
            'axis_names': list(mesh.axis_names),
            'shape': [int(s) for s in mesh.devices.shape]},
        'kwargs': kwargs,
        'torch_version': torch.__version__,
        'kernel_hash': _kernel_hash(),
        'kernel_library': library is not None,
    }
    deployed = Deployed(
        fn, meta, embedded=(_host_array(tables.coeffs),) if slim else None,
        device=device, library=library)
    if path is not None:
        deployed.save(path)
    return deployed


def _kernel_hash():
    """The hash in the kernel library's file name: of this tree's kernel
    sources, headers and flags."""
    name = os.path.basename(_build.library_path())
    return name.rsplit('_', 1)[-1].split('.')[0]


class Deployed:
    """A loaded/exported pipeline artifact: ``deployed(dat)`` runs it on
    its ``device`` (or its mesh).

    Fixed-batch artifacts accept any leading batch size: the inputs stream
    through in chunks of the exported batch (``parallel.stream_map``: the
    last one padded, NaN for floats, zero otherwise; padded rows are sliced
    off the outputs).
    """

    def __init__(self, fn, meta, embedded=None, device=None, library=None):
        self.fn = fn
        self.meta = dict(meta)
        self.device = resolve_device(device)
        self._embedded = embedded     # (coeffs,) for slim artifacts
        self._library = library       # the built kernel library's bytes
        self._placed = {}             # (id(tables), id(mesh)) -> placement
        self._default_mesh = None
        if self.meta.get('slim') and embedded is None:
            raise ValueError('slim artifact without its embedded '
                             'coefficients — load() it from the zip')

    def save(self, path):
        """Write the artifact (zip of JSON metadata; slim artifacts also
        carry their embedded coefficient table; artifacts exported beside
        a card, the built kernel library).  Raises when a custom pipeline
        cannot be imported back by its stored ``module:qualname``."""
        stored = self.meta['pipeline']
        if stored not in PIPELINES and _resolve_pipeline(stored) is not \
                self.fn:
            raise ValueError(
                f'the custom pipeline is stored as {stored!r}, which '
                'imports back as another object: define it at module '
                'level to save it')
        with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as z:
            z.writestr('meta.json', json.dumps(self.meta, indent=1))
            if self._embedded is not None:
                bio = io.BytesIO()
                np.savez(bio, coeffs=np.asarray(self._embedded[0]))
                z.writestr('tables.npz', bio.getvalue())
            if self._library is not None:
                z.writestr(_LIBRARY, self._library)
        return path

    def _mesh(self, mesh):
        """Resolve the serving mesh for a sharded artifact (or None)."""
        want = self.meta.get('mesh')
        if want is None:
            if mesh is not None:
                raise ValueError(
                    'this artifact was not exported with mesh= — the '
                    'passed serving mesh would be silently ignored; '
                    're-export with export_pipeline(..., mesh=mesh) for '
                    'sharded serving')
            return None
        shape = tuple(want['shape'])
        if mesh is None:
            if self._default_mesh is not None:
                return self._default_mesh
            n = int(np.prod(shape))
            if self.device.type == 'cuda':
                avail = torch.cuda.device_count()
                if avail != n:
                    raise ValueError(
                        f'artifact was exported for {n} devices; {avail} '
                        'available — pass a matching mesh= or re-export')
                devices = None
            else:
                devices = [self.device] * n     # the host is any mesh
            mesh = make_mesh(devices, axis_names=tuple(want['axis_names']),
                             shape=shape)
            self._default_mesh = mesh
        # The batch is laid out over the first mesh axis, so the serving
        # mesh must have the exported axis shape, not just its size.
        if tuple(int(s) for s in mesh.devices.shape) != shape:
            raise ValueError(f'artifact was exported on a mesh of shape '
                             f'{shape}; serving mesh has shape '
                             f'{tuple(mesh.devices.shape)}')
        return mesh

    def _place_tables(self, tables, mesh):
        """The tables as the pipeline takes them, on the artifact's device
        (replicated over ``mesh``) and in its recorded dtypes: the full
        tables, or just the embedded coefficients for slim artifacts.
        Memoized per (tables, mesh) pair, at most 4 of them: serving loops
        must not copy them on every call.  The value tuple pins both keys'
        referents so a recycled ``id()`` can never alias a dead entry."""
        if self.meta.get('slim') and tables is None:
            tables = self          # the embedded coefficients are the key
        key = (id(tables), None if mesh is None else id(mesh))
        memo = self._placed.get(key)
        if memo is not None and memo[0] is tables and memo[1] is mesh:
            self._placed.pop(key)        # re-insert: LRU recency
            self._placed[key] = memo
            return memo[2]
        if self.meta.get('slim'):
            if tables is self:
                raw = (self._embedded[0],)
            else:
                c = getattr(tables, 'coeffs', tables)
                if c is None:
                    raise ValueError(
                        'this slim artifact needs spectral coefficients '
                        'but tables.coeffs is None — pass tables=None to '
                        'use the embedded ones')
                raw = (c,)
        else:
            # Exports of tables without coefficients carry 2 leaves.
            n_tab = len(self.meta.get('table_dtypes') or ()) or 3
            raw = (tables.curves, tables.lookup,
                   getattr(tables, 'coeffs', None))[:n_tab]
            if n_tab == 3 and raw[2] is None:
                raise ValueError(
                    'this artifact was exported with spectral '
                    'coefficients but the serving tables have '
                    'coeffs=None — rebuild with '
                    'load_moist_adiabat_lookups()')
        want = self.meta.get('table_dtypes') or [None] * len(raw)
        device = self.device if mesh is None else mesh.local_devices()[0]
        # Each array in its exported dtype (curves, lookup and coefficients
        # can differ: a downcast table keeps its wider lookup); tensors
        # that are there in that dtype already are used as they are.
        def place(a, w):
            a = to_tensor(a, device)
            return a if w is None else a.to(_torch_dtype(w))

        arrs = [place(a, w) for a, w in zip(raw, want)]
        if len(arrs) == 1:
            tab = adiabat.AdiabatTables(arrs[0])
        elif len(arrs) == 3:
            tab = adiabat.AdiabatTables(arrs[2], arrs[0], arrs[1])
        else:
            tab = types.SimpleNamespace(curves=arrs[0], lookup=arrs[1],
                                        coeffs=None)
        if mesh is not None:
            tab = replicate(tab, mesh)
        self._placed[key] = (tables, mesh, tab)
        # Bounded: a serving loop that makes fresh tables (or a fresh
        # mesh) per call must not pin every dead pair and its copies.
        while len(self._placed) > 4:
            self._placed.pop(next(iter(self._placed)))
        return tab

    def check_inputs(self, dat):
        """Split ``dat`` against the exported input contract.

        Returns ``(kept, missing, extra)``: the recognized variables, the
        required names absent from ``dat``, and the unrecognized names
        that were dropped.  The single source of truth for input
        validation on every serving surface (CLI, ``xarray_api.serve``):
        callers fail on ``missing`` with a clear message.
        """
        expected = set(input_spec(1, levels=self.meta['levels'],
                                  wind_levels=self.meta['wind_levels']))
        missing = sorted(expected - set(dat))
        extra = sorted(set(dat) - expected)
        kept = {k: v for k, v in dat.items() if k in expected}
        return kept, missing, extra

    @staticmethod
    def _host(out):
        """A served output tree on the host, as numpy arrays.  Sharded
        outputs are gathered: across processes each gets the full value
        (and every process must make the call)."""
        def one(x):
            return x.numpy() if isinstance(x, Sharded) else _host_array(x)
        return _map_leaves(one, out)

    def _run(self, dat, tab, mesh):
        """The pipeline on one batch: host arrays or tensors in, device
        tensors (``Sharded`` under a mesh) out."""
        kwargs = self.meta.get('kwargs') or {}
        if mesh is None:
            return dict(self.fn({k: to_tensor(v, self.device)
                                 for k, v in dat.items()},
                                tables=tab, **kwargs))
        return sharded_map(
            lambda d, tables: dict(self.fn(d, tables=tables, **kwargs)),
            mesh)(dat, tables=tab)

    def __call__(self, dat, tables=None, mesh=None):
        """Serve one batch.  Exact-fit and polymorphic calls return device
        tensors (``parallel.Sharded`` under a mesh); any other batch is
        streamed in chunks and returns host numpy arrays."""
        if not dat:
            raise ValueError('empty input dict — nothing to serve')
        dat, missing, extra = self.check_inputs(dat)
        if missing or extra:
            # Fail on names here, the lowest serving surface, so a typo'd
            # key reads as "missing X / unrecognized Y".  Callers that
            # want to drop extras silently (CLI, xarray_api.serve)
            # pre-filter via check_inputs.
            raise ValueError(
                f'input does not match the exported contract: '
                f'missing {missing or "nothing"}, '
                f'unrecognized {extra or "nothing"}')
        bad = sorted(k for k, v in dat.items() if not np.shape(v))
        if bad:
            raise ValueError('inputs must carry a leading batch dim; '
                             f'0-d fields: {bad}')
        sizes = {np.shape(v)[0] for v in dat.values()}
        if len(sizes) != 1:
            raise ValueError(f'mixed leading batch dims: {sorted(sizes)}')
        b = sizes.pop()
        if b == 0:
            raise ValueError('empty batch (leading dim 0) — nothing to '
                             'serve')
        # Trailing extents must match the exported contract too: fail
        # here with the variable named.
        spec = input_spec(1, levels=self.meta['levels'],
                          wind_levels=self.meta['wind_levels'])
        wrong = {k: (tuple(np.shape(v)[1:]), tuple(spec[k][0][1:]))
                 for k, v in dat.items()
                 if tuple(np.shape(v)[1:]) != tuple(spec[k][0][1:])}
        if wrong:
            raise ValueError(
                'input extents beyond the batch dim do not match the '
                'exported contract (got vs exported): ' + ', '.join(
                    f'{k}: {g} vs {w}'
                    for k, (g, w) in sorted(wrong.items())))
        # Float inputs are coerced to the exported dtype like the CLI and
        # xarray_api.serve do, so all three surfaces accept default-dtype
        # numpy inputs: host arrays on the host, tensors where they are.
        # Matching dtypes pass through untouched.
        want = np.dtype(self.meta.get('dtype', 'float32'))

        def _coerce(v):
            if torch.is_tensor(v):
                return (v.to(_torch_dtype(want)) if v.is_floating_point()
                        else v)
            v = np.asarray(v)
            if v.dtype.kind == 'f' and v.dtype != want:
                return v.astype(want)
            return v

        dat = {k: _coerce(v) for k, v in dat.items()}

        mesh = self._mesh(mesh)
        if not self.meta.get('slim'):
            # Slim artifacts carry their coefficients; only full-table
            # artifacts load the cache in a fresh serving process.
            tables = _tables_or_load(
                tables, self.meta.get('table_dtype'),
                self.device if mesh is None else mesh.local_devices()[0],
                full=True)
        tab = self._place_tables(tables, mesh)

        bex = self.meta.get('batch')
        if bex is None or b == bex:     # polymorphic, or an exact fit
            return self._run(dat, tab, mesh)

        # Mismatched batch: streamed from the host in chunks of the
        # exported batch (NaN-padded, sharded over the mesh), each chunk's
        # copies in and out overlapping its neighbours' compute.  Outputs
        # come back as host arrays.
        kwargs = self.meta.get('kwargs') or {}

        def run(chunk):
            here = next(iter(chunk.values())).device
            return dict(self.fn(
                chunk, tables=tab if mesh is None else tab.on(here),
                **kwargs))

        return stream_map(
            run, {k: _host_array(v) for k, v in dat.items()},
            batch_columns=bex, level_vars=('pressure',),
            device=self.device if mesh is None else None, mesh=mesh)


def _read_meta(path):
    """Artifact metadata alone; friendly errors for non-zip files and zips
    that are not artifacts."""
    try:
        with zipfile.ZipFile(path) as z:
            return json.loads(z.read('meta.json'))
    except (KeyError, zipfile.BadZipFile) as e:
        raise ValueError(
            'not an xarray-parcel-tpu-torch exported artifact (expected a '
            f'zip containing meta.json): {path}') from e


def _install_library(z, meta):
    """Put the artifact's kernel library where ``_build`` looks for this
    tree's, if it is not there and was built from these sources: a fresh
    serving process then needs no ``nvcc``."""
    if not meta.get('kernel_library') or _LIBRARY not in z.namelist():
        return
    path = _build.library_path()
    if meta.get('kernel_hash') != _kernel_hash() or os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        f.write(z.read(_LIBRARY))
    os.replace(tmp, path)


def load(path, device=None):
    """Load a :class:`Deployed` artifact written by :meth:`Deployed.save`,
    to run on ``device`` (None: the GPU)."""
    meta = _read_meta(path)
    if meta.get('format') in _FORMATS_JAX:
        raise ValueError(
            f'{path} is an artifact of the JAX package '
            f'({meta.get("format")!r}): it holds a StableHLO program, '
            'which this package cannot run — export the pipeline again '
            'with xarray_parcel_tpu_torch.deploy')
    if meta.get('format') not in _FORMATS_READ:
        raise ValueError(
            f'not an xarray-parcel-tpu-torch exported artifact '
            f'(readable formats: {sorted(_FORMATS_READ)}, got '
            f'{meta.get("format")!r}): {path}')
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        embedded = library = None
        if meta.get('slim'):
            with np.load(io.BytesIO(z.read('tables.npz'))) as d:
                embedded = (d['coeffs'],)
        if _LIBRARY in z.namelist():
            library = z.read(_LIBRARY)
        if device.type == 'cuda':
            _install_library(z, meta)
    return Deployed(_resolve_pipeline(meta['pipeline']), meta,
                    embedded=embedded, device=device, library=library)


def _parse_mesh_spec(spec):
    """'8' -> (8,); '4x2' -> (4, 2) — SystemExit on anything else."""
    try:
        shape = tuple(int(s) for s in spec.lower().split('x'))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: expected e.g. '8' or "
                         "'4x2'") from None
    if not shape or any(s < 1 for s in shape):
        raise SystemExit(f'--mesh {spec!r}: axis sizes must be positive')
    return shape


def _build_cli_mesh(shape, names, device):
    """Mesh of the given axis shape/names from the first N local devices
    of ``device``'s type (the host counts as any number)."""
    n = int(np.prod(shape))
    if device.type == 'cuda':
        avail = torch.cuda.device_count()
        if avail < n:
            raise SystemExit(f'mesh shape {shape} needs {n} devices; '
                             f'{avail} available')
        devices = [torch.device('cuda', i) for i in range(n)]
    else:
        devices = [device] * n
    return make_mesh(devices, axis_names=names, shape=shape)


def _cli_export(args):
    slim = {'auto': None, 'true': True, 'false': False}[args.slim]
    device = resolve_device(args.device)
    tables = None
    if args.tables:
        tables = adiabat.AdiabatTables.load(args.tables, device)
    mesh = None
    if args.mesh:
        # The batch dim shards over the first axis; a second axis
        # replicates (e.g. '4x2').  Axis names follow the library
        # convention so `serve --mesh` round-trips.
        shape = _parse_mesh_spec(args.mesh)
        if len(shape) > 2:
            raise SystemExit(f'--mesh {args.mesh!r}: at most 2 axes '
                             '(batch x replication)')
        if args.polymorphic:
            raise SystemExit('--mesh and --polymorphic are mutually '
                             'exclusive (a batch of any size cannot carry a '
                             'fixed sharding); export a fixed batch')
        if args.batch % shape[0]:
            raise SystemExit(
                f'--batch {args.batch} is not divisible by the '
                f'{shape[0]}-way batch axis of --mesh {args.mesh!r}')
        mesh = _build_cli_mesh(shape, ('data', 'model')[:len(shape)], device)
    dep = export_pipeline(
        args.pipeline,
        batch=None if args.polymorphic else args.batch,
        levels=args.levels, wind_levels=args.wind_levels,
        dtype=np.dtype(args.dtype), tables=tables, mesh=mesh,
        polymorphic=args.polymorphic,
        device=None if mesh is not None else device,
        slim=slim, path=args.output)
    print(f'wrote {args.output} ({os.path.getsize(args.output):,} bytes, '
          f"slim={dep.meta['slim']}, platforms={dep.meta['platforms']}, "
          f"kernel library={dep.meta['kernel_library']})")
    return 0


def _cli_serve(args):
    device = resolve_device(args.device)
    dep = load(args.artifact, device=device)
    mesh = None
    if args.mesh:
        # Without this flag a mesh-exported artifact serves only when the
        # process's device count equals the exported one (Deployed._mesh).
        want = dep.meta.get('mesh')
        if want is None:
            raise SystemExit('--mesh: this artifact was not exported with '
                             'mesh= (see `info`); it serves unsharded')
        shape = _parse_mesh_spec(args.mesh)
        names = tuple(want['axis_names'])
        # The serving mesh must have the exported axis shape: say so here
        # rather than letting Deployed._mesh raise mid-serve.
        if shape != tuple(want['shape']):
            raise SystemExit(
                f'--mesh {args.mesh!r}: the artifact was exported on a '
                f'mesh of shape {"x".join(str(s) for s in want["shape"])} '
                f'(axes {names}); the serving mesh must match it')
        mesh = _build_cli_mesh(shape, names, device)
    tables = None
    if args.tables:
        tables = adiabat.AdiabatTables.load(args.tables, device)
    with np.load(args.input) as f:
        dat = {k: f[k] for k in f.files}
    dat, missing, extra = dep.check_inputs(dat)
    if missing:
        raise SystemExit(f'input {args.input} is missing required '
                         f'variables: {missing}')
    if extra:
        print(f'ignoring {len(extra)} unrecognized variables: {extra}')
    out = dep._host(dep(dat, tables=tables, mesh=mesh))
    # Through a file handle: np.savez on a path appends '.npz' when the
    # extension is missing, making the printed name lie.
    with open(args.output, 'wb') as f:
        np.savez(f, **out)
    b = next(iter(out.values())).shape[0]
    print(f'wrote {args.output}: {len(out)} variables x {b:,} columns')
    return 0


def _cli_info(args):
    # meta.json only: info works on any artifact, also one whose pipeline
    # this process cannot import.
    print(json.dumps(_read_meta(args.artifact), indent=1))
    return 0


def main(argv=None):
    """``python -m xarray_parcel_tpu_torch.deploy``: export/serve from the
    command line.  With slim artifacts (the default) the serving side
    needs only the artifact zip and an ``.npz`` of input columns."""
    import argparse
    p = argparse.ArgumentParser(
        prog='python -m xarray_parcel_tpu_torch.deploy',
        description='Export and file-to-file serving of the convection '
                    'pipelines.')
    sub = p.add_subparsers(dest='cmd', required=True)
    device_help = "where to run: None is the GPU, 'cpu' the host"

    pe = sub.add_parser('export', help='export a pipeline artifact')
    pe.add_argument('--pipeline', default='conv_properties',
                    choices=sorted(PIPELINES))
    pe.add_argument('--batch', type=int, default=1 << 16)
    pe.add_argument('--levels', type=int, default=90)
    pe.add_argument('--wind-levels', type=int, default=None)
    pe.add_argument('--dtype', default='float32')
    pe.add_argument('--polymorphic', action='store_true')
    pe.add_argument('--device', default=None, help=device_help)
    pe.add_argument('--slim', default='auto',
                    choices=('auto', 'true', 'false'))
    pe.add_argument('--tables', default=None,
                    help='table .npz (default: the default tables)')
    pe.add_argument('--mesh', default=None,
                    help="export for a device mesh of this shape, e.g. '8' "
                         "or '4x2' (batch shards over the first axis; uses "
                         "the first N local devices)")
    pe.add_argument('-o', '--output', required=True)
    pe.set_defaults(run=_cli_export)

    ps = sub.add_parser('serve', help='run an .npz of columns through an '
                                      'artifact')
    ps.add_argument('artifact')
    ps.add_argument('--input', required=True, help='.npz of input columns')
    ps.add_argument('-o', '--output', required=True, help='.npz to write')
    ps.add_argument('--tables', default=None,
                    help='table .npz (full-table artifacts only)')
    ps.add_argument('--device', default=None, help=device_help)
    ps.add_argument('--mesh', default=None,
                    help="serving mesh shape for a mesh-exported artifact, "
                         "e.g. '8' or '4x2' (matches the exported axis "
                         "shape; uses the first N local devices)")
    ps.set_defaults(run=_cli_serve)

    pi = sub.add_parser('info', help='print artifact metadata')
    pi.add_argument('artifact')
    pi.set_defaults(run=_cli_info)

    args = p.parse_args(argv)
    return args.run(args)


if __name__ == '__main__':
    raise SystemExit(main())
