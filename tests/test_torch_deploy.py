"""The port's deployment artifacts (``deploy``) against the JAX package's.

The counterpart of every case of ``tests/test_deploy.py``, on the CPU
(``device='cpu'``), with the same seeded inputs (``test_deploy.make_dat``)
through both packages.  The port's tables hold the JAX package's
coefficient array (``AdiabatTables.from_numpy``), so an artifact built from
it carries the JAX package's state.

Tolerances, float64.  Against the JAX package (its ``Deployed`` for the
shared batch-16 artifact, its pipelines elsewhere): identical NaN patterns
and 1e-8 absolute.  Against the port's direct call: exact where the served
batch has the direct call's shape (exact fit, polymorphic, save and load,
fresh process); where the artifact pads and chunks, or shards, identical NaN
patterns and 1e-6 of each output's scale, because on the CPU a chunk's shape
takes other vector paths than the whole batch's.

Cases of the JAX file that have no meaning in eager PyTorch are here as
tests of what the port does instead: a float64 artifact needs no switch, a
fused pipeline exports polymorphic, there is no compile cache, and a
pipeline that reads the tables' shapes fails the slim probe and exports
full.
"""

import io
import json
import os
import subprocess
import sys
import types
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import deploy as jdeploy
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu import xarray_api as jx
from xarray_parcel_tpu_torch import AdiabatTables, _build
from xarray_parcel_tpu_torch import adiabat as tad
from xarray_parcel_tpu_torch import deploy, parallel, pipeline
from xarray_parcel_tpu_torch import xarray_api as tx
from xarray_parcel_tpu_torch.parallel import Sharded

from test_deploy import make_dat as jax_make_dat
from test_torch_ops import assert_same
from test_torch_surface import (assert_meta_same, assert_scaled, dataset,
                                values)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = np.float64
CPU = dict(device='cpu')


def make_dat(B, L=24, seed=3):
    """``test_deploy.make_dat`` as host numpy arrays."""
    return {k: np.array(v) for k, v in jax_make_dat(B, L, seed).items()}


def tensors(dat):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in dat.items()}


def host(out):
    return deploy.Deployed._host(out)


def assert_exact(got, ref):
    got, ref = host(got), host(ref)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def assert_chunked(got, ref):
    got, ref = host(got), host(ref)
    assert set(got) == set(ref)
    for k in ref:
        assert_scaled(ref[k], got[k], name=k)


def assert_jax(got, jref):
    got = host(got)
    assert set(got) == set(jref)
    assert_same({k: np.asarray(v) for k, v in jref.items()}, got, atol=1e-8)


# Custom pipelines: at module level, so that an artifact can store them.

def lookup_pipeline(dat, tables=None):
    out = dict(pipeline.min_conv_properties(dat, tables=tables))
    out['ml_probe'] = tad.moist_lapse(
        dat['pressure'], dat['temperature'][..., 0], tables=tables,
        index_mode='bilinear', curve_blend=False)[..., 5]
    return out


def lookup_only(dat, tables=None):
    """Reads curves and lookup themselves, never the coefficients: the one
    kind of pipeline that runs on tables without them (the port's
    ``moist_lapse`` needs coefficients in every mode)."""
    t0 = dat['temperature'][..., 0]
    column = torch.clamp((t0 - tad.T_MIN) / tad.T_STEP, 0,
                         tad.N_TEMP - 1).long()
    fidx = tables.lookup[0][column]
    return {'fidx': fidx.to(t0.dtype),
            'start': tables.curves[:, 0][torch.nan_to_num(fidx).long()]}


def shape_reader(dat, tables=None):
    out = dict(pipeline.min_conv_properties(dat, tables=tables))
    out['lookup_rows'] = torch.full_like(dat['pressure'][:, 0],
                                         float(tables.lookup.shape[0]))
    return out


def scaled_pipeline(dat, tables=None, factor=1.0, prefix='x'):
    out = pipeline.min_conv_properties_fused(dat, tables=tables)
    return {f'{prefix}_cape': out['mixed_100_cape'] * factor}


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    """The JAX package's coefficients alone."""
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


@pytest.fixture(scope='module')
def full_tables(jax_tables):
    return AdiabatTables.from_numpy(
        np.asarray(jax_tables.coeffs), 'cpu', torch.float64,
        curves=np.asarray(jax_tables.curves),
        lookup=np.asarray(jax_tables.lookup))


@pytest.fixture(scope='module')
def mesh():
    return parallel.make_mesh(['cpu'] * 8)


@pytest.fixture(scope='module')
def artifact16(tables, tmp_path_factory):
    """One batch-16 min_conv_properties export shared by several tests."""
    path = tmp_path_factory.mktemp('deploy') / 'min_pipe.xpz'
    deployed = deploy.export_pipeline('min_conv_properties', batch=16,
                                      levels=24, dtype=F64, tables=tables,
                                      path=path, **CPU)
    return path, deployed


@pytest.fixture(scope='module')
def jax_artifact16(jax_tables, tmp_path_factory):
    """The JAX package's artifact of the same pipeline and batch."""
    path = tmp_path_factory.mktemp('jdeploy') / 'min_pipe.xpz'
    deployed = jdeploy.export_pipeline('min_conv_properties', batch=16,
                                       levels=24, dtype=jnp.float64,
                                       tables=jax_tables, path=path)
    return path, deployed


def direct(name, dat, tables, **kwargs):
    return getattr(pipeline, name)(tensors(dat), tables=tables, **kwargs)


def test_export_save_load_roundtrip(tables, artifact16, jax_artifact16):
    path, deployed = artifact16
    dat = make_dat(16)
    assert path.exists()
    loaded = deploy.load(path, **CPU)
    assert loaded.meta['pipeline'] == 'min_conv_properties'
    assert loaded.meta['batch'] == 16
    assert loaded.meta['levels'] == 24
    assert loaded.meta['platforms'] == ['cpu']
    assert loaded.meta['torch_version'] == torch.__version__
    assert loaded.meta['kernel_library'] is False   # no nvcc on this box
    ref = direct('min_conv_properties', dat, tables)
    out = deployed(dat, tables=tables)
    assert all(torch.is_tensor(v) for v in out.values())   # exact fit
    assert_exact(out, ref)
    assert_exact(loaded(dat, tables=tables), ref)
    assert_jax(out, jax_artifact16[1](dat))


@pytest.mark.parametrize('B', [21, 37])
def test_fixed_batch_serves_any_grid(tables, artifact16, jax_artifact16, B):
    # 21 columns (pad within one chunk) and 37 (two chunks + pad) through
    # a batch-16 artifact must equal the direct whole-batch call.
    loaded = deploy.load(artifact16[0], **CPU)
    dat = make_dat(B, seed=B)
    got = loaded(dat, tables=tables)
    assert all(isinstance(v, np.ndarray) and v.shape[0] == B
               for v in got.values())
    assert_chunked(got, direct('min_conv_properties', dat, tables))
    assert_jax(got, jax_artifact16[1](dat))


def test_fixed_batch_edge_errors(tables, artifact16, mesh):
    _, deployed = artifact16
    empty = {k: v[:0] for k, v in make_dat(4).items()}
    with pytest.raises(ValueError, match='empty batch'):
        deployed(empty, tables=tables)
    mixed = make_dat(8)
    mixed['surface_wind_u'] = mixed['surface_wind_u'][:4]
    with pytest.raises(ValueError, match='mixed leading batch'):
        deployed(mixed, tables=tables)
    with pytest.raises(ValueError, match='polymorphic=True'):
        deploy.export_pipeline('min_conv_properties', batch=None,
                               tables=tables, **CPU)
    with pytest.raises(ValueError, match='must be >= 1'):
        deploy.export_pipeline('min_conv_properties', batch=0,
                               tables=tables, **CPU)
    # A mesh passed to an unsharded artifact must raise, not be ignored.
    with pytest.raises(ValueError, match='not exported with mesh'):
        deployed(make_dat(16), tables=tables, mesh=mesh)
    with pytest.raises(ValueError, match='unknown pipeline'):
        deploy.export_pipeline('no_such_pipeline', batch=4, tables=tables,
                               **CPU)


def test_polymorphic_batch(tables, jax_tables):
    deployed = deploy.export_pipeline('min_conv_properties', batch=None,
                                      levels=24, dtype=F64, tables=tables,
                                      polymorphic=True, **CPU)
    assert deployed.meta['batch'] is None and deployed.meta['polymorphic']
    for B in (8, 13):
        dat = make_dat(B, seed=B)
        out = deployed(dat, tables=tables)
        assert all(torch.is_tensor(v) and v.shape[0] == B
                   for v in out.values())
        assert_exact(out, direct('min_conv_properties', dat, tables))
        assert_jax(out, jpipeline.min_conv_properties(
            {k: jnp.asarray(v) for k, v in dat.items()}, tables=jax_tables))
    # The polymorphic path validates inputs like the fixed-batch path.
    mixed = make_dat(8)
    mixed['surface_wind_u'] = mixed['surface_wind_u'][:4]
    with pytest.raises(ValueError, match='mixed leading batch'):
        deployed(mixed, tables=tables)
    scalar = make_dat(8)
    scalar['surface_wind_u'] = np.float64(3.0)
    with pytest.raises(ValueError, match='0-d'):
        deployed(scalar, tables=tables)
    with pytest.raises(ValueError, match='empty input'):
        deployed({}, tables=tables)


def test_table_placement_memoized(tables, artifact16):
    # Serving loops must not copy the tables per call: same (tables, mesh)
    # pair -> one placement entry, identical objects.
    _, deployed = artifact16
    deployed._placed.clear()
    dat = make_dat(16, seed=40)
    deployed(dat, tables=tables)
    first = dict(deployed._placed)
    deployed(dat, tables=tables)
    assert len(deployed._placed) == 1
    (key, val), = deployed._placed.items()
    assert val[2] is first[key][2]
    # Tensors that are on the device in the exported dtype are not copied.
    assert val[2].coeffs is tables.coeffs
    # A second tables object is a second entry, not an eviction.
    deployed(dat, tables=AdiabatTables(tables.coeffs))
    assert len(deployed._placed) == 2


def test_table_dtype_follows_artifact(full_tables, monkeypatch):
    # A full-table artifact exported with float32 tables must serve from a
    # process whose default would be another flavour: the recorded table
    # dtype, not the serving process, chooses what is loaded.
    tab32 = full_tables.astype(torch.float32)
    deployed = deploy.export_pipeline('min_conv_properties', batch=8,
                                      levels=24, dtype=np.float32,
                                      tables=tab32, slim=False, **CPU)
    assert deployed.meta['table_dtype'] == 'float32'
    assert deployed.meta['table_dtypes'] == ['float32'] * 3
    dat = {k: v.astype(np.float32) for k, v in make_dat(8, seed=41).items()}
    ref = deployed(dat, tables=tab32)
    asked = []

    def fake_load(dtype=None, device=None, **kw):
        asked.append((dtype, torch.device(device)))
        return tab32

    monkeypatch.setattr(tad, 'load_moist_adiabat_lookups', fake_load)
    monkeypatch.setattr(tad, '_LOADED', None)
    monkeypatch.setattr(tad, '_DEFAULTS', {})
    got = deployed(dat)                 # tables=None: loads them itself
    assert asked == [(torch.float32, torch.device('cpu'))]
    assert_exact(got, ref)
    # Float64 serving tables are cast to the exported dtypes.
    assert_exact(deployed(dat, tables=full_tables), ref)


def test_custom_callable_polymorphic(tables):
    """No kernel needs a fixed batch, so a custom callable exports
    polymorphic whatever it is named; there is no ``uses_pallas``."""
    def my_fused_alias(dat, tables=None):
        return pipeline.min_conv_properties_fused(dat, tables=tables)
    my_fused_alias.uses_pallas = True
    dep = deploy.export_pipeline(my_fused_alias, batch=None,
                                 polymorphic=True, levels=24, dtype=F64,
                                 tables=tables, **CPU)
    assert dep.meta['polymorphic'] is True and dep.meta['slim'] is True
    assert dep.meta['pipeline'].endswith(':test_custom_callable_polymorphic.'
                                         '<locals>.my_fused_alias')
    dat = make_dat(9, seed=4)
    assert_exact(dep(dat), direct('min_conv_properties_fused', dat, tables))


def test_fused_pipeline_exports(tables, jax_tables, tmp_path):
    path = tmp_path / 'fused.xpz'
    deploy.export_pipeline('min_conv_properties_fused', batch=8, levels=24,
                           dtype=F64, tables=tables, path=path, **CPU)
    loaded = deploy.load(path, **CPU)
    dat = make_dat(8, seed=5)
    got = loaded(dat, tables=tables)
    assert_exact(got, direct('min_conv_properties_fused', dat, tables))
    assert_jax(got, jpipeline.min_conv_properties_fused(
        {k: jnp.asarray(v) for k, v in dat.items()}, tables=jax_tables))


def test_sharded_export(tables, mesh, jax_artifact16, tmp_path):
    # A mesh artifact: batch sharded over 8 entries, tables replicated.
    # Must reload and serve both an exact-fit batch (stays sharded end to
    # end) and a non-divisible grid (pad + chunk, each chunk sharded).
    path = tmp_path / 'sharded.xpz'
    deploy.export_pipeline('min_conv_properties', batch=16, levels=24,
                           dtype=F64, tables=tables, mesh=mesh, path=path)
    loaded = deploy.load(path, **CPU)
    assert loaded.meta['mesh'] == {'axis_names': ['data'], 'shape': [8]}

    dat = make_dat(16, seed=21)
    ref = direct('min_conv_properties', dat, tables)
    got = loaded(dat, tables=tables, mesh=mesh)
    assert isinstance(got['mixed_100_cape'], Sharded)
    assert len(got['mixed_100_cape'].shards) == 8
    assert_chunked(got, ref)
    assert_jax(got, jax_artifact16[1](dat))
    # Default mesh resolution (mesh=None) and the pad/chunk path.
    dat23 = make_dat(23, seed=22)
    got23 = loaded(dat23, tables=tables)
    assert loaded._default_mesh.devices.shape == (8,)
    assert_chunked(got23, direct('min_conv_properties', dat23, tables))
    assert_jax(got23, jax_artifact16[1](dat23))

    with pytest.raises(ValueError, match='divide evenly'):
        deploy.export_pipeline('min_conv_properties', batch=15, levels=24,
                               dtype=F64, tables=tables, mesh=mesh)
    with pytest.raises(ValueError, match='do not compose'):
        deploy.export_pipeline('min_conv_properties', batch=None,
                               polymorphic=True, tables=tables, mesh=mesh)
    # Same size but another axis layout must be rejected.
    mesh42 = parallel.make_mesh(['cpu'] * 8, axis_names=('data', 'model'),
                                shape=(4, 2))
    with pytest.raises(ValueError, match='mesh of shape'):
        loaded(dat, tables=tables, mesh=mesh42)
    # A 2-axis mesh shards the batch over axis 0 only: batch 12 is legal
    # on a (4, 2) mesh (12 % 4 == 0) even though 12 % 8 != 0.
    dep42 = deploy.export_pipeline('min_conv_properties', batch=12,
                                   levels=24, dtype=F64, tables=tables,
                                   mesh=mesh42)
    dat12 = make_dat(12, seed=23)
    assert_chunked(dep42(dat12, mesh=mesh42),
                   direct('min_conv_properties', dat12, tables))
    with pytest.raises(ValueError, match='is not in the mesh'):
        deploy.export_pipeline('min_conv_properties', batch=16,
                               tables=tables, mesh=mesh, device='meta')


def test_polymorphic_fused_runs(tables):
    """The CUDA kernels take any batch: the fused pipelines export
    polymorphic, where the JAX package's raise."""
    with pytest.raises(ValueError, match='polymorphic batch is XLA-only'):
        jdeploy.export_pipeline('conv_properties_fused', batch=None,
                                polymorphic=True)
    dep = deploy.export_pipeline('conv_properties_fused', batch=None,
                                 polymorphic=True, levels=24, dtype=F64,
                                 tables=tables, **CPU)
    dat = make_dat(11, seed=6)
    assert_exact(dep(dat), direct('conv_properties_fused', dat, tables))


def test_load_rejects_foreign_zip(tmp_path):
    path = tmp_path / 'other.zip'
    with zipfile.ZipFile(path, 'w') as z:
        z.writestr('meta.json', '{"format": "something-else"}')
    with pytest.raises(ValueError, match='not a'):
        deploy.load(path, **CPU)


def test_load_refuses_a_jax_artifact_by_name(jax_artifact16):
    with pytest.raises(ValueError, match='artifact of the JAX package'):
        deploy.load(jax_artifact16[0], **CPU)
    # `info` still reads its metadata.
    assert deploy._read_meta(jax_artifact16[0])['pipeline'] == \
        'min_conv_properties'


def test_exported_kwargs_are_stored_and_applied(tables, jax_tables,
                                                tmp_path):
    dat = make_dat(8, seed=7)
    dat['temperature'][0, 3] = np.nan
    path = tmp_path / 'kw.xpz'
    deployed = deploy.export_pipeline('conv_properties', batch=8, levels=24,
                                      dtype=F64, tables=tables,
                                      ignore_nans=True, path=path, **CPU)
    assert deployed.meta['kwargs'] == {'ignore_nans': True}
    with zipfile.ZipFile(path) as z:
        assert json.loads(z.read('meta.json'))['kwargs'] == {
            'ignore_nans': True}
    ref = direct('conv_properties', dat, tables, ignore_nans=True)
    masked = direct('conv_properties', dat, tables)
    assert torch.isnan(masked['mu_cape'][0]) and not torch.isnan(
        ref['mu_cape'][0])
    got = deploy.load(path, **CPU)(dat)
    assert_exact(got, ref)
    assert_jax(got, jpipeline.conv_properties(
        {k: jnp.asarray(v) for k, v in dat.items()}, tables=jax_tables,
        ignore_nans=True))


def test_kwargs_round_trip_and_must_be_json(tables, tmp_path):
    path = tmp_path / 'custom.xpz'
    dep = deploy.export_pipeline(scaled_pipeline, batch=8, levels=24,
                                 dtype=F64, tables=tables, factor=2.5,
                                 prefix='twice', path=path, **CPU)
    assert dep.meta['pipeline'] == 'test_torch_deploy:scaled_pipeline'
    loaded = deploy.load(path, **CPU)
    assert loaded.fn is scaled_pipeline
    assert loaded.meta['kwargs'] == {'factor': 2.5, 'prefix': 'twice'}
    dat = make_dat(8, seed=8)
    ref = direct('min_conv_properties_fused', dat, tables)
    assert_exact(loaded(dat), {'twice_cape': ref['mixed_100_cape'] * 2.5})
    with pytest.raises(ValueError, match='JSON'):
        deploy.export_pipeline(scaled_pipeline, batch=8, levels=24,
                               tables=tables, factor=torch.ones(2), **CPU)
    # A callable that cannot be imported back exports, but does not save.
    local = deploy.export_pipeline(
        lambda dat, tables=None: scaled_pipeline(dat, tables), batch=8,
        levels=24, dtype=F64, tables=tables, **CPU)
    assert_exact(local(dat), {'x_cape': ref['mixed_100_cape']})
    with pytest.raises(ValueError, match='importable|imports back'):
        local.save(tmp_path / 'local.xpz')


def test_with_proxies_pipeline_exports(tables, jax_tables):
    dat = make_dat(8, seed=9)
    deployed = deploy.export_pipeline('conv_properties_with_proxies',
                                      batch=8, levels=24, dtype=F64,
                                      tables=tables, **CPU)
    ref = dict(direct('conv_properties', dat, tables))
    ref.update(pipeline.storm_proxies(ref))
    got = deployed(dat, tables=tables)
    assert 'ship' in got and 'proxy_Craven2004' in got
    assert_exact(got, ref)
    jref = dict(jpipeline.conv_properties(
        {k: jnp.asarray(v) for k, v in dat.items()}, tables=jax_tables))
    jref.update(jpipeline.storm_proxies(jref))
    assert_jax(got, jref)


def serve_in_a_fresh_process(child, timeout=300):
    proc = subprocess.run([sys.executable, '-c', child], timeout=timeout,
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_artifact_serves_in_a_fresh_process(tables, artifact16, tmp_path):
    # A process that never saw the tables loads the artifact and
    # reproduces this process's results, with an empty table cache.
    path, deployed = artifact16
    dat = make_dat(16, seed=33)
    ref = deployed(dat, tables=tables)
    datfile, outfile = tmp_path / 'dat.npz', tmp_path / 'out.npz'
    np.savez(datfile, **dat)
    child = (
        "import os\n"
        f"os.environ['XPARCEL_TORCH_TABLE_CACHE'] = "
        f"{str(tmp_path / 'no_cache.npz')!r}\n"
        "import numpy as np\n"
        "from xarray_parcel_tpu_torch import deploy, adiabat\n"
        # The artifact is slim: serving must never touch the table
        # cache/build path.  Make any attempt fail loudly.
        "def _no(*a, **k): raise RuntimeError('tables must not load')\n"
        "adiabat.load_moist_adiabat_lookups = _no\n"
        "adiabat.AdiabatTables.build = _no\n"
        f"dat = dict(np.load({str(datfile)!r}))\n"
        f"dep = deploy.load({str(path)!r}, device='cpu')\n"
        "assert dep.meta['slim'] is True\n"
        "out = dep(dat)\n"                       # embedded coefficients
        f"np.savez({str(outfile)!r}, **dep._host(out))\n")
    serve_in_a_fresh_process(child)
    assert not (tmp_path / 'no_cache.npz').exists()
    assert_exact(dict(np.load(outfile)), ref)


def test_slim_artifact_is_standalone(tables, jax_tables, artifact16,
                                     jax_artifact16):
    """Auto-slim: registry pipelines read only tables.coeffs, so the
    artifact embeds them and serves with no tables argument and no module
    table state: the zip is the whole deployment."""
    path, deployed = artifact16
    assert deployed.meta['slim'] is True
    assert deployed.meta['table_dtypes'] == ['float64']
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) == {'meta.json', 'tables.npz'}
    dat = make_dat(16, seed=50)
    ref = direct('min_conv_properties', dat, tables)
    assert_exact(deployed(dat), ref)
    loaded = deploy.load(path, **CPU)
    assert loaded._embedded is not None
    # The JAX package's coefficient array, carried across.
    np.testing.assert_array_equal(loaded._embedded[0],
                                  np.asarray(jax_tables.coeffs))
    np.testing.assert_array_equal(loaded._embedded[0],
                                  jax_artifact16[1]._embedded[0])
    assert_exact(loaded(dat), ref)
    assert_jax(loaded(dat), jax_artifact16[1](dat))
    # Embedded placement is memoized under a stable key.
    loaded._placed.clear()
    loaded(dat)
    first = dict(loaded._placed)
    loaded(dat)
    assert len(loaded._placed) == 1
    (key, val), = loaded._placed.items()
    assert val[2] is first[key][2]
    # A Deployed made from the JAX package's array directly.
    made = deploy.Deployed(pipeline.min_conv_properties, loaded.meta,
                           embedded=(np.asarray(jax_tables.coeffs),), **CPU)
    assert_exact(made(dat), ref)
    with pytest.raises(ValueError, match='without its embedded'):
        deploy.Deployed(pipeline.min_conv_properties, loaded.meta, **CPU)
    with pytest.raises(ValueError, match='tables.coeffs is None'):
        loaded(dat, tables=types.SimpleNamespace(coeffs=None))


def test_slim_false_forces_full_tables(full_tables, tables, tmp_path):
    path = tmp_path / 'full.xpz'
    deploy.export_pipeline('min_conv_properties', batch=8, levels=24,
                           dtype=F64, tables=full_tables, slim=False,
                           path=path, **CPU)
    loaded = deploy.load(path, **CPU)
    assert loaded.meta['slim'] is False
    assert len(loaded.meta['table_dtypes']) == 3
    with zipfile.ZipFile(path) as z:
        assert 'tables.npz' not in set(z.namelist())
    dat = make_dat(8, seed=51)
    assert_exact(loaded(dat, tables=full_tables),
                 direct('min_conv_properties', dat, full_tables))
    with pytest.raises(ValueError, match='needs tables with'):
        deploy.export_pipeline('min_conv_properties', batch=8, levels=24,
                               dtype=F64, tables=tables, slim=False, **CPU)


def test_slim_rejects_table_reading_pipeline(full_tables):
    """A pipeline that gathers from the full tables: slim=True raises
    naming the array; auto (None) falls back to full-table."""
    with pytest.raises(ValueError, match='curves.*lookup|lookup'):
        deploy.export_pipeline(lookup_pipeline, batch=8, levels=24,
                               dtype=F64, tables=full_tables, slim=True,
                               **CPU)
    dep = deploy.export_pipeline(lookup_pipeline, batch=8, levels=24,
                                 dtype=F64, tables=full_tables, **CPU)
    assert dep.meta['slim'] is False
    dat = make_dat(8, seed=52)
    got = dep(dat, tables=full_tables)
    assert 'ml_probe' in got and torch.isfinite(got['ml_probe']).any()
    assert_exact(got, lookup_pipeline(tensors(dat), tables=full_tables))


def test_slim_sharded_export(tables, mesh, jax_artifact16):
    # slim + mesh: the embedded coefficients replicate over the mesh.
    dep = deploy.export_pipeline('min_conv_properties', batch=16,
                                 levels=24, dtype=F64, tables=tables,
                                 mesh=mesh)
    assert dep.meta['slim'] is True
    dat = make_dat(16, seed=53)
    got = dep(dat, mesh=mesh)          # no tables at all
    assert len(got['mixed_100_cape'].shards) == 8
    assert_chunked(got, direct('min_conv_properties', dat, tables))
    assert_jax(got, jax_artifact16[1](dat))


def write_coeff_tables(tables, path):
    tables.save(path)
    return str(path)


def test_cli_export_serve_info(tables, jax_artifact16, tmp_path, capsys):
    """python -m xarray_parcel_tpu_torch.deploy: export -> serve file to
    file (slim artifact; no tables anywhere on the serving side)."""
    art = tmp_path / 'cli.xpz'
    tabfile = write_coeff_tables(tables, tmp_path / 'coeffs.npz')
    assert deploy.main(['export', '--pipeline', 'min_conv_properties',
                        '--batch', '8', '--levels', '24',
                        '--dtype', 'float64', '--device', 'cpu',
                        '--tables', tabfile, '-o', str(art)]) == 0
    dat = make_dat(12, seed=60)
    infile, outfile = tmp_path / 'in.npz', tmp_path / 'out.npz'
    np.savez(infile, **dat, junk=np.arange(12.0))
    assert deploy.main(['serve', str(art), '--input', str(infile),
                        '--device', 'cpu', '-o', str(outfile)]) == 0
    got = dict(np.load(outfile))
    assert_chunked(got, direct('min_conv_properties', dat, tables))
    assert_jax(got, jax_artifact16[1](dat))
    assert deploy.main(['info', str(art)]) == 0
    out = capsys.readouterr().out
    assert '"slim": true' in out
    assert 'ignoring 1 unrecognized' in out
    assert 'kernel library=False' in out
    # Missing required variables fail with their names.
    np.savez(infile, pressure=dat['pressure'])
    with pytest.raises(SystemExit, match='missing required'):
        deploy.main(['serve', str(art), '--input', str(infile),
                     '--device', 'cpu', '-o', str(outfile)])


def test_cli_serve_mesh_exported_artifact(tables, tmp_path):
    """`export --mesh 4` then `serve --mesh 4`; output equals the direct
    single-device pipeline."""
    art = tmp_path / 'mesh4.xpz'
    tabfile = write_coeff_tables(tables, tmp_path / 'coeffs.npz')
    common = ['--device', 'cpu']
    assert deploy.main(['export', '--pipeline', 'min_conv_properties',
                        '--batch', '8', '--levels', '24', '--dtype',
                        'float64', '--mesh', '4', '--tables', tabfile,
                        '-o', str(art)] + common) == 0
    assert deploy.load(art, **CPU).meta['mesh'] == {'axis_names': ['data'],
                                                    'shape': [4]}
    dat = make_dat(12, seed=61)
    infile, outfile = tmp_path / 'in.npz', tmp_path / 'out.npz'
    np.savez(infile, **dat)
    assert deploy.main(['serve', str(art), '--input', str(infile),
                        '--mesh', '4', '-o', str(outfile)] + common) == 0
    assert_chunked(dict(np.load(outfile)),
                   direct('min_conv_properties', dat, tables))
    # Mismatched mesh shape and an unsharded artifact both fail clearly.
    with pytest.raises(SystemExit, match='must match it'):
        deploy.main(['serve', str(art), '--input', str(infile),
                     '--mesh', '2x2', '-o', str(outfile)] + common)
    flat = tmp_path / 'flat.xpz'
    deploy.export_pipeline('min_conv_properties', batch=8, levels=24,
                           dtype=F64, tables=tables, path=flat, **CPU)
    with pytest.raises(SystemExit, match='not exported with mesh'):
        deploy.main(['serve', str(flat), '--input', str(infile),
                     '--mesh', '8', '-o', str(outfile)] + common)
    for bad, match in (('3xq', 'expected e.g.'), ('0', 'must be positive')):
        with pytest.raises(SystemExit, match=match):
            deploy._parse_mesh_spec(bad)
    assert deploy._parse_mesh_spec('4x2') == (4, 2)
    for extra, match in ((['--mesh', '2x2x2'], 'at most 2 axes'),
                         (['--mesh', '4', '--polymorphic'],
                          'mutually exclusive'),
                         (['--mesh', '3'], 'not divisible')):
        with pytest.raises(SystemExit, match=match):
            deploy.main(['export', '--batch', '8', '--tables', tabfile,
                         '-o', str(art)] + extra + common)


def test_shape_reading_pipeline_exports_full(full_tables, tables):
    """A custom pipeline that consults ``tables.lookup.shape`` has nothing
    to read on coefficient-only probe tables: the probe fails, so auto
    exports the full-table artifact and ``slim=True`` raises the probe's
    error.  (The JAX package gives such a pipeline shaped placeholders;
    there is no traced program to put them in here.)"""
    dep = deploy.export_pipeline(shape_reader, batch=8, levels=24,
                                 dtype=F64, tables=full_tables, **CPU)
    assert dep.meta['slim'] is False
    got = dep(make_dat(8, seed=54), tables=full_tables)
    np.testing.assert_array_equal(
        got['lookup_rows'].numpy(),
        np.full(8, float(full_tables.lookup.shape[0])))
    with pytest.raises(AttributeError):
        deploy.export_pipeline(shape_reader, batch=8, levels=24, dtype=F64,
                               tables=full_tables, slim=True, **CPU)


def test_slim_format_is_v2_full_is_v1(full_tables, artifact16,
                                      jax_artifact16):
    """Slim artifacts are format v2, full-table ones v1; neither is one of
    the JAX package's format strings."""
    _, deployed = artifact16
    assert deployed.meta['format'] == 'xarray-parcel-tpu-torch-exported-v2'
    full = deploy.export_pipeline('min_conv_properties', batch=8,
                                  levels=24, dtype=F64, tables=full_tables,
                                  slim=False, **CPU)
    assert full.meta['format'] == 'xarray-parcel-tpu-torch-exported-v1'
    assert jax_artifact16[1].meta['format'] not in deploy._FORMATS_READ


def test_spectral_less_tables_export_full_table(full_tables, tmp_path):
    """Tables without coefficients: auto-slim falls back to a 2-leaf
    full-table artifact, slim=True raises the documented message, and the
    2-leaf artifact serves."""
    bare = types.SimpleNamespace(curves=full_tables.curves,
                                 lookup=full_tables.lookup, coeffs=None)
    with pytest.raises(ValueError, match='coeffs is None'):
        deploy.export_pipeline(lookup_only, batch=8, levels=24, dtype=F64,
                               tables=bare, slim=True, **CPU)
    dep = deploy.export_pipeline(lookup_only, batch=8, levels=24, dtype=F64,
                                 tables=bare, path=tmp_path / 'bare.xpz',
                                 **CPU)
    assert dep.meta['slim'] is False
    assert len(dep.meta['table_dtypes']) == 2
    assert dep.meta['format'] == 'xarray-parcel-tpu-torch-exported-v2'
    dat = make_dat(8, seed=55)
    ref = lookup_only(tensors(dat), tables=bare)
    assert_exact(deploy.load(tmp_path / 'bare.xpz', **CPU)(dat, tables=bare),
                 ref)
    # Serving a 3-leaf artifact with coeffs-less tables names the problem.
    three = deploy.export_pipeline('min_conv_properties', batch=8,
                                   levels=24, dtype=F64, tables=full_tables,
                                   slim=False, **CPU)
    with pytest.raises(ValueError, match='coeffs=None'):
        three(dat, tables=bare)


def test_cli_serves_f64_artifact_in_a_default_process(tables, artifact16,
                                                      tmp_path):
    """A float64 artifact serves from a default process: no switch is
    needed, and the output file keeps its exact name."""
    path, _ = artifact16
    dat = make_dat(8, seed=56)
    infile = tmp_path / 'in.npz'
    outfile = tmp_path / 'out.results'   # no .npz: exact-name write
    np.savez(infile, **dat)
    proc = subprocess.run(
        [sys.executable, '-m', 'xarray_parcel_tpu_torch.deploy', 'serve',
         str(path), '--input', str(infile), '--device', 'cpu', '-o',
         str(outfile)], timeout=300, capture_output=True, text=True,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert outfile.exists()              # savez did not append '.npz'
    got = dict(np.load(outfile))
    assert got['mixed_100_cape'].dtype == np.float64
    assert_chunked(got, direct('min_conv_properties', dat, tables))


def test_call_rejects_wrong_variable_names(artifact16):
    _, deployed = artifact16
    dat = make_dat(16, seed=57)
    dat['presure'] = dat.pop('pressure')        # typo: missing + extra
    with pytest.raises(ValueError, match=r"missing \['pressure'\].*"
                                         r"unrecognized \['presure'\]"):
        deployed(dat)


def test_cli_export_records_the_tables_dtype(tables, tmp_path):
    """`export --dtype float32 --tables f64.npz` records and embeds the
    float64 coefficients of the file."""
    tabfile = write_coeff_tables(tables, tmp_path / 'tabs_f64.npz')
    outfile = tmp_path / 'f64tab.xpz'
    assert deploy.main(['export', '--pipeline', 'min_conv_properties',
                        '--batch', '8', '--levels', '24', '--dtype',
                        'float32', '--tables', tabfile, '--device', 'cpu',
                        '-o', str(outfile)]) == 0
    with zipfile.ZipFile(outfile) as z:
        meta = json.loads(z.read('meta.json'))
        assert meta['dtype'] == 'float32'
        assert meta['table_dtypes'] == ['float64']      # slim: coeffs only
        with np.load(io.BytesIO(z.read('tables.npz'))) as d:
            assert d['coeffs'].dtype == np.float64


def test_there_is_no_compile_cache():
    """Nothing is compiled at serve time, so the port has neither
    ``enable_compilation_cache`` nor the CLI's ``--cache``."""
    assert hasattr(jdeploy, 'enable_compilation_cache')
    assert not hasattr(deploy, 'enable_compilation_cache')
    with pytest.raises(SystemExit):
        deploy.main(['serve', 'x.xpz', '--input', 'in.npz', '-o', 'o.npz',
                     '--cache', 'dir'])


def test_export_f64_in_a_default_process(tables):
    """No x64 switch exists: float64 exports and serves as it is, from
    numpy, torch and named dtypes."""
    dat = make_dat(4, seed=58)
    ref = direct('min_conv_properties', dat, tables)
    for dtype in (np.float64, torch.float64, 'float64'):
        dep = deploy.export_pipeline('min_conv_properties', batch=4,
                                     levels=24, dtype=dtype, tables=tables,
                                     **CPU)
        assert dep.meta['dtype'] == 'float64'
        assert_exact(dep(dat), ref)
    with pytest.raises(TypeError, match='float32 or float64'):
        deploy.export_pipeline('min_conv_properties', batch=4,
                               dtype=np.int32, tables=tables, **CPU)


def test_call_coerces_float_dtypes(tables, artifact16, jax_artifact16):
    # __call__ casts mismatched float inputs to the exported dtype, host
    # arrays and tensors alike.
    _, deployed = artifact16
    dat32 = {k: v.astype(np.float32)
             for k, v in make_dat(16, seed=11).items()}
    ref = direct('min_conv_properties',
                 {k: v.astype(np.float64) for k, v in dat32.items()}, tables)
    assert_exact(deployed(dat32, tables=tables), ref)
    assert_exact(deployed(tensors(dat32), tables=tables), ref)
    assert_jax(deployed(dat32), jax_artifact16[1](dat32))


def test_call_rejects_wrong_extents(tables, artifact16):
    _, deployed = artifact16
    dat = {k: v[:, :20] if v.ndim == 2 else v
           for k, v in make_dat(16).items()}
    with pytest.raises(ValueError, match='extents.*pressure'):
        deployed(dat, tables=tables)


def test_table_placement_is_bounded(tables, artifact16):
    _, deployed = artifact16
    dat = make_dat(16)
    for _ in range(6):
        deployed(dat, tables=AdiabatTables(tables.coeffs))
    assert len(deployed._placed) <= 4


def test_load_friendly_errors(tmp_path):
    not_zip = tmp_path / 'notes.txt'
    not_zip.write_text('hello')
    with pytest.raises(ValueError, match='not an xarray-parcel-tpu'):
        deploy.load(not_zip, **CPU)
    plain = tmp_path / 'plain.zip'
    with zipfile.ZipFile(plain, 'w') as z:
        z.writestr('readme.txt', 'x')
    with pytest.raises(ValueError, match='not an xarray-parcel-tpu'):
        deploy.load(plain, **CPU)
    # The device comes before anything is read: none here without a GPU.
    with pytest.raises(RuntimeError, match='no CUDA device'):
        deploy.export_pipeline('min_conv_properties', batch=4)


def test_cli_info_reads_metadata_only(tmp_path, capsys):
    art = tmp_path / 'foreign.xpz'
    meta = {'format': 'some-other-format/1', 'pipeline': 'not.a:pipeline',
            'torch_version': '99.0'}
    with zipfile.ZipFile(art, 'w') as z:
        z.writestr('meta.json', json.dumps(meta))
    assert deploy.main(['info', str(art)]) == 0
    assert json.loads(capsys.readouterr().out)['torch_version'] == '99.0'
    meta['format'] = deploy._FORMAT
    with zipfile.ZipFile(art, 'w') as z:
        z.writestr('meta.json', json.dumps(meta))
    with pytest.raises(ValueError, match='nor importable'):
        deploy.load(art, **CPU)


@pytest.mark.parametrize('same_hash', [True, False])
def test_kernel_library_is_installed_only_for_this_trees_hash(
        tmp_path, monkeypatch, same_hash):
    """The artifact's library goes to ``_build.library_path()`` when it was
    built from this tree's sources and the file is absent; another hash is
    ignored (the library is then built as usual), not an error."""
    target = tmp_path / 'build' / 'libxpt_kernels_0123456789abcdef.so'
    monkeypatch.setattr(_build, 'library_path', lambda: str(target))
    assert deploy._kernel_hash() == '0123456789abcdef'
    meta = {'kernel_library': True, 'kernel_hash': (
        '0123456789abcdef' if same_hash else 'ffffffffffffffff')}
    art = tmp_path / 'lib.zip'
    with zipfile.ZipFile(art, 'w') as z:
        z.writestr(deploy._LIBRARY, b'not really a library')
    with zipfile.ZipFile(art) as z:
        deploy._install_library(z, meta)
        assert target.exists() == same_hash
        if same_hash:
            assert target.read_bytes() == b'not really a library'
            target.write_bytes(b'already here')
            deploy._install_library(z, meta)     # present: left alone
            assert target.read_bytes() == b'already here'


def test_serve_dataset_equals_the_pipeline_and_jax(tables, jax_tables,
                                                   artifact16,
                                                   jax_artifact16):
    """``xarray_api.serve``: Dataset in, attributed Dataset out, through a
    ``Deployed`` or a path; a grid of 35 columns through batch 16."""
    ds = dataset(ny=5, nx=7, dewpoint=True)
    path, _ = artifact16
    wide = deploy.export_pipeline('min_conv_properties', batch=16,
                                  levels=16, dtype=F64, tables=tables,
                                  **CPU)
    want = tx.min_conv_properties(ds, tables=tables, dtype=np.float64, **CPU)
    got = tx.serve(ds, wide)
    assert_meta_same(want, got)
    for k in want.data_vars:
        assert values(got[k]).shape == (5, 7)
        assert_scaled(values(want[k]), values(got[k]), name=k)
    jwide = jdeploy.export_pipeline('min_conv_properties', batch=16,
                                    levels=16, dtype=jnp.float64,
                                    tables=jax_tables)
    jgot = jx.serve(ds, jwide)
    assert_meta_same(jgot, got)
    for k in want.data_vars:
        assert_same(values(jgot[k]), values(got[k]), atol=1e-8, name=k)
    # The mixed-dims layout broadcasts before it flattens.
    mixed = dataset('mixed', ny=5, nx=7)
    assert_meta_same(tx.min_conv_properties(mixed, tables=tables,
                                            dtype=np.float64, **CPU),
                     tx.serve(mixed, wide))
    with pytest.raises(ValueError, match='missing variables'):
        tx.serve(tx.xr.Dataset({'pressure': ds['pressure']}), wide)
    # By path the artifact loads on the default device: none here.
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tx.serve(ds, path)
