"""The port's device mesh (``parallel.mesh``, ``mesh=``) against the JAX
package's on its 8-device CPU mesh.

The port's mesh here is ``make_mesh(['cpu'] * 8)``: eight entries on the
host, the counterpart of ``--xla_force_host_platform_device_count=8``.  The
same numpy inputs, made from a seed, go through both packages.

Tolerances.  Layouts, padding and the reductions' counts: exact.  A sharded
or streamed run against the same function applied shard by shard: exact
(that is what sharding computes).  Against the port's direct run on the
whole batch: identical NaN patterns and 1e-6 of each output's scale in
float64, because on the CPU a shard's shape takes other vector paths than
the whole batch's and the last bits differ (as ``test_torch_stream.py``
holds streamed runs).  Against the JAX package's sharded results: 1e-8
absolute on CAPE/CIN-like fields in float64; Dataset pipelines, which the
JAX surface lowers to float32, to the float32 budget.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import parallel as jparallel
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu import xarray_api as jx
from xarray_parcel_tpu_torch import AdiabatTables, _build
from xarray_parcel_tpu_torch import adiabat as tad
from xarray_parcel_tpu_torch import parallel
from xarray_parcel_tpu_torch import pipeline as tpipeline
from xarray_parcel_tpu_torch import xarray_api as tx
from xarray_parcel_tpu_torch.fused import fused_surface_cape_cin
from xarray_parcel_tpu_torch.parallel import (Sharded, global_stats,
                                              make_mesh, pad_batch,
                                              replicate, shard_batch,
                                              sharded_map, stream_map)

import chip_smoke
from test_distributed import _free_port, _make_grid
from test_torch_ops import assert_same
from test_torch_surface import (assert_f32_budget, assert_meta_same,
                                assert_scaled, dataset, values)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(scope='module')
def mesh():
    return make_mesh(['cpu'] * 8)


@pytest.fixture(scope='module')
def jmesh():
    assert jax.device_count() >= 8, 'conftest must force 8 host devices'
    return jparallel.make_mesh(jax.devices()[:8])


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


def grid_sounding(b=16, L=24):
    """The soundings of ``tests/test_sharding.py``, as float64 arrays."""
    rng = np.random.default_rng(3)
    p = np.linspace(1000.0, 200.0, L)
    t = 300.0 - 70.0 * (1 - (p / 1000.0) ** 0.28)
    t = np.broadcast_to(t, (b, L)) + rng.normal(0, 1.5, (b, L))
    td = t - np.abs(rng.normal(6, 4, (b, L)))
    return np.broadcast_to(p, (b, L)).copy(), t, td


def pipeline_columns(B, L, seed):
    dat, _ = chip_smoke.synthetic(B, L=L, seed=seed)
    return {k: v.astype(np.float64) for k, v in dat.items()}


def tensors(dat):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in dat.items()}


def per_shard(fn, dat, n):
    """``fn`` on each of ``n`` equal shards of the leading dim,
    concatenated: what a sharded run computes."""
    B = next(iter(dat.values())).shape[0]
    m = B // n
    outs = [fn(tensors({k: v[i * m:(i + 1) * m] for k, v in dat.items()}))
            for i in range(n)]
    return {k: torch.cat([o[k] for o in outs]).numpy() for k in outs[0]}


def assert_direct(want, got, name=''):
    for k in want:
        assert_scaled(np.asarray(want[k]), np.asarray(got[k]),
                      name=f'{name}/{k}')


# --- the mesh and its layouts ------------------------------------------------

def test_make_mesh_shapes_and_names(mesh):
    assert mesh.devices.shape == (8,) and mesh.axis_names == ('data',)
    assert mesh.shape == {'data': 8} and mesh.size == 8
    assert set(mesh.devices.ravel()) == {torch.device('cpu')}
    assert mesh.processes == 1 and len(mesh.entries()) == 8
    m42 = make_mesh(['cpu'] * 8, axis_names=('data', 'model'), shape=(4, 2))
    assert m42.devices.shape == (4, 2)
    # Replica axes hold no shards: four entries compute.
    assert [key for key, _ in m42.entries()] == [(0,), (1,), (2,), (3,)]
    with pytest.raises(ValueError, match='does not hold'):
        make_mesh(['cpu'] * 8, shape=(3,))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_mesh()


def test_shard_batch_layout(mesh, jmesh):
    p, _, _ = grid_sounding()
    sp = shard_batch(p, mesh)
    jsp = jparallel.shard_batch(jnp.asarray(p), jmesh)
    assert isinstance(sp, Sharded) and sp.shape == jsp.shape == (16, 24)
    assert sp.spec == parallel.batch_spec(mesh, 2, 1) == ('data', None)
    assert sp.spec == tuple(jsp.sharding.spec)
    # The level axis stays whole on every device.
    assert {tuple(s.shape) for s in sp.shards.values()} == {(2, 24)} == {
        s.data.shape for s in jsp.addressable_shards}
    for js in jsp.addressable_shards:
        key = (js.index[0].start // 2,)
        np.testing.assert_array_equal(sp.shards[key].numpy(),
                                      np.asarray(js.data))
    np.testing.assert_array_equal(np.asarray(sp), p)
    assert parallel.replicated(mesh) == ()


def test_shard_batch_1d_leaf_shards_its_only_dim(mesh):
    """A 1-D leaf is a surface field (B,): its single dim is the batch."""
    x = shard_batch(np.arange(16.0), mesh)
    assert {tuple(s.shape) for s in x.shards.values()} == {(2,)}
    assert x.spec == ('data',)
    tree = shard_batch({'a': [np.zeros((8, 3)), torch.arange(8)],
                        'n': None, 's': 2.5}, mesh)
    assert tree['a'][0].shape == (8, 3) and tree['a'][1].dtype == torch.int64
    assert tree['n'] is None and tree['s'] == 2.5


def test_shard_batch_uneven_names_pad_batch(mesh):
    with pytest.raises(ValueError, match='pad_batch'):
        shard_batch(np.zeros((35, 4)), mesh)


def test_shard_batch_two_batch_dims():
    m42 = make_mesh(['cpu'] * 8, axis_names=('y', 'x'), shape=(4, 2))
    a = np.arange(8 * 6 * 3.0).reshape(8, 6, 3)
    s = shard_batch(a, m42, batch_dims=2)
    assert s.spec == ('y', 'x', None) and len(s.shards) == 8
    assert {tuple(v.shape) for v in s.shards.values()} == {(2, 3, 3)}
    np.testing.assert_array_equal(s.numpy(), a)
    out = sharded_map(lambda v: v.sum(-1), m42, batch_dims=2)(a)
    np.testing.assert_array_equal(out.numpy(), a.sum(-1))


# --- sharded runs ------------------------------------------------------------

def test_sharded_cape_matches_single_device(mesh, jmesh, tables, jax_tables):
    p, t, td = grid_sounding()

    def fn(p, t, td, tables):
        res, _ = fused_surface_cape_cin(p, t, td, tables=tables)
        return res['cape'], res['cin']

    got = sharded_map(fn, mesh)(p, t, td, tables=replicate(tables, mesh))
    assert all(isinstance(g, Sharded) and len(g.shards) == 8 for g in got)
    want = fn(*(torch.from_numpy(x) for x in (p, t, td)), tables)
    for g, w in zip(got, want):
        assert_scaled(w.numpy(), g.numpy())
    halves = [fn(*(torch.from_numpy(x[i:i + 2]) for x in (p, t, td)), tables)
              for i in range(0, 16, 2)]
    for j, g in enumerate(got):
        np.testing.assert_array_equal(
            g.numpy(), torch.cat([h[j] for h in halves]).numpy())

    from xarray_parcel_tpu import fused as jfused

    def jfn(p, t, td):
        res, _ = jfused.fused_surface_cape_cin(p, t, td, tables=jax_tables,
                                               interpret=True)
        return res['cape'], res['cin']

    jgot = jparallel.sharded_jit(jfn, jmesh)(p, t, td)
    for g, w in zip(got, jgot):
        assert_same(np.asarray(w), g.numpy(), atol=1e-8)


def test_replicated_tables_sharded_columns(mesh, jmesh, tables, jax_tables):
    copies = replicate(tables, mesh)
    assert set(copies.copies) == {torch.device('cpu')}
    assert copies.on('cpu') is tables           # there already: no copy
    moved = replicate({'t': tables, 'a': np.arange(3.0)}, mesh).on('cpu')
    assert moved['t'] is tables and torch.equal(
        moved['a'], torch.arange(3.0, dtype=torch.float64))
    p, _, _ = grid_sounding()

    def lift(pp, tables):
        return tad.moist_lapse(pp, torch.tensor(293.0, dtype=pp.dtype),
                               torch.tensor(1000.0, dtype=pp.dtype),
                               tables=tables)

    out = sharded_map(lift, mesh)(p, tables=copies)
    assert out.shape == (16, 24)
    jout = jax.jit(lambda pp: jad.moist_lapse(pp, 293.0, 1000.0,
                                              tables=jparallel.replicate(
                                                  jax_tables, jmesh)))(
        jparallel.shard_batch(jnp.asarray(p), jmesh))
    assert_same(np.asarray(jout), out.numpy(), atol=1e-8)
    assert_scaled(lift(torch.from_numpy(p), tables).numpy(), out.numpy())


def test_sharded_map_runs_each_entry_on_its_own_thread(mesh):
    seen = []
    together = threading.Barrier(8)

    def fn(x):
        # All eight entries must be in flight at once to pass the barrier.
        together.wait(timeout=60)
        seen.append((threading.get_ident(), torch.is_grad_enabled()))
        return x * 2

    with torch.no_grad():
        out = sharded_map(fn, mesh)(np.arange(16.0))
    np.testing.assert_array_equal(out.numpy(), np.arange(16.0) * 2)
    assert len({ident for ident, _ in seen}) == 8
    assert threading.get_ident() not in {ident for ident, _ in seen}
    assert not any(grad for _, grad in seen)     # the caller's grad mode

    def broken(x):
        raise RuntimeError('shard failed')

    with pytest.raises(RuntimeError, match='shard failed'):
        sharded_map(broken, mesh)(np.arange(16.0))


def test_launch_counter_is_exact_under_threads():
    """Many threads bumping one kernel's count lose no launch (the
    kernels count through ``_build.count``)."""
    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count(wrapper, 'launches')
                            for _ in range(2000)]) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000


# --- global_stats ------------------------------------------------------------

def test_global_stats_collectives(mesh, jmesh):
    x = np.arange(16.0).reshape(16, 1)
    x[3, 0] = np.nan
    cnt, mean, mx = global_stats(shard_batch(x, mesh), mesh)
    jcnt, jmean, jmx = jparallel.global_stats(
        jparallel.shard_batch(jnp.asarray(x), jmesh), jmesh)
    finite = np.delete(np.arange(16.0), 3)
    assert int(cnt) == int(jcnt) == 15
    np.testing.assert_almost_equal(float(mean), finite.mean(), 10)
    np.testing.assert_almost_equal(float(mean), float(jmean), 10)
    assert float(mx) == float(jmx) == 15.0


def test_global_stats_all_nan_uneven_and_non_float(mesh, jmesh):
    nan = np.full(16, np.nan)
    cnt, mean, mx = global_stats(shard_batch(nan, mesh), mesh)
    jcnt, jmean, jmx = jparallel.global_stats(jnp.asarray(nan), jmesh)
    assert int(cnt) == int(jcnt) == 0
    assert np.isnan(float(mean)) and np.isnan(float(jmean))
    assert float(mx) == float(jmx) == -np.inf
    # An uneven float batch is NaN-padded here; an array is sharded here.
    x = np.arange(35.0)
    cnt, mean, mx = global_stats(x, mesh)
    jcnt, jmean, jmx = jparallel.global_stats(jnp.asarray(x), jmesh)
    assert (int(cnt), float(mean), float(mx)) == (35, 17.0, 34.0)
    assert (int(jcnt), float(jmean), float(jmx)) == (35, 17.0, 34.0)
    ints = torch.arange(16)
    assert [float(v) for v in global_stats(ints, mesh)] == [16.0, 7.5, 15.0]
    for fn, arr in ((global_stats, np.arange(35)),
                    (jparallel.global_stats, jnp.arange(35))):
        with pytest.raises(ValueError, match='cannot be NaN-padded'):
            fn(arr, mesh if fn is global_stats else jmesh)
    with pytest.raises(ValueError, match='no mesh axis'):
        global_stats(x, mesh, axis_name='model')


# --- pad_batch ---------------------------------------------------------------

def test_pad_batch_uneven_rounds_up_and_slices(mesh, jmesh):
    tree = {'a': np.arange(35.0 * 4).reshape(35, 4), 'b': np.arange(35.0)}
    padded, b = pad_batch(tree, mesh)
    jpadded, jb = jparallel.pad_batch(tree, jmesh)
    assert b == jb == 35
    assert padded['a'].shape == (40, 4) and padded['b'].shape == (40,)
    for k in tree:
        np.testing.assert_array_equal(padded[k], jpadded[k])
    assert np.isnan(padded['a'][35:]).all()
    np.testing.assert_array_equal(padded['a'][:35], tree['a'])
    out = sharded_map(lambda d: d['a'].sum(-1) + d['b'], mesh)(padded)
    np.testing.assert_allclose(out.numpy()[:b],
                               tree['a'].sum(-1) + tree['b'])
    assert np.isnan(out.numpy()[b:]).all()
    # Already-divisible batches pass through unchanged.
    tree2 = {'a': np.ones((16, 3))}
    padded2, b2 = pad_batch(tree2, mesh)
    assert b2 == 16 and padded2['a'].shape == (16, 3)
    padded3, _ = pad_batch(tree, mesh, fill=-1.0)
    assert (padded3['b'][35:] == -1.0).all()


def test_pad_batch_integer_and_bool_leaves_pad_with_zero(mesh, jmesh):
    tree = {'cape': np.ones(35), 'station': np.arange(35, dtype=np.int32),
            'mask': np.ones(35, dtype=bool)}
    padded, b = pad_batch(tree, mesh)
    jpadded, _ = jparallel.pad_batch(tree, jmesh)
    assert b == 35
    for k in tree:
        assert padded[k].dtype == tree[k].dtype == jpadded[k].dtype
        np.testing.assert_array_equal(padded[k], jpadded[k])
    assert (padded['station'][35:] == 0).all()
    assert (~padded['mask'][35:]).all()
    assert np.isnan(padded['cape'][35:]).all()


def test_pad_batch_rejects_mixed_and_empty_trees(mesh):
    with pytest.raises(ValueError, match='mixed leading-dim sizes'):
        pad_batch({'a': np.zeros(5), 'b': np.zeros(6)}, mesh)
    with pytest.raises(ValueError, match='empty pytree'):
        pad_batch({}, mesh)


# --- stream_map(mesh=) -------------------------------------------------------

def test_stream_map_sharded_chunks_match_direct(mesh, jmesh, tables,
                                                jax_tables):
    """B=27 and chunks of 10: the chunk rounds up to 16, so two chunks,
    each split over all 8 entries; results equal the unsharded run."""
    B, L = 27, 30
    dat = pipeline_columns(B, L, seed=11)

    def fn(d):
        return tpipeline.min_conv_properties(d, tables=tables)

    direct = fn(tensors(dat))
    streamed = stream_map(fn, dat, batch_columns=10, mesh=mesh)
    assert_direct({k: v.numpy() for k, v in direct.items()}, streamed,
                  'streamed')
    # Exactly what it computes: the function on each padded piece.
    padded, _ = pad_batch(dat, make_mesh(['cpu'] * 32))
    pieces = per_shard(fn, padded, 16)
    for k in streamed:
        np.testing.assert_array_equal(streamed[k], pieces[k][:B], err_msg=k)
    jstreamed = jparallel.stream_map(
        lambda d: jpipeline.min_conv_properties(d, tables=jax_tables), dat,
        batch_columns=10, mesh=jmesh)
    for k in jstreamed:
        assert_same(jstreamed[k], streamed[k], atol=1e-8, name=k)

    # Witness the placement: every chunk lands on all 8 entries, at the
    # rounded-up chunk size, and the entries run at once: each call waits
    # until the calls of all 8 entries have reached the barrier (a serial
    # run would break it at its timeout).
    seen = []
    lock = threading.Lock()
    meet = threading.Barrier(8, timeout=60)

    def probe(d):
        with lock:
            seen.append(tuple(d['pressure'].shape))
        meet.wait()
        return {'x': d['pressure'][..., 0]}

    out = stream_map(probe, dat, batch_columns=10, mesh=mesh)
    np.testing.assert_array_equal(out['x'], dat['pressure'][:, 0])
    assert len(seen) == 16 and set(seen) == {(2, L)}


def test_stream_map_mesh_pads_ints_and_keeps_order(mesh):
    B = 101
    dat = {'pressure': np.tile(np.linspace(1000.0, 300.0, 7), (B, 1)),
           'colid': np.arange(B, dtype=np.float64),
           'station': np.arange(B, dtype=np.int32)}

    def fn(d):
        return {'twice': d['colid'] * 2.0, 's2': d['station'] * 2}

    for prefetch in (1, 3):
        out = stream_map(fn, dat, batch_columns=20, mesh=mesh,
                         prefetch=prefetch)
        np.testing.assert_array_equal(out['twice'], dat['colid'] * 2.0)
        np.testing.assert_array_equal(out['s2'], dat['station'] * 2)
        assert out['s2'].dtype == np.int32
    empty = stream_map(fn, {k: v[:0] for k, v in dat.items()}, mesh=mesh)
    assert empty['twice'].shape == (0,)
    with pytest.raises(ValueError, match='is not in the mesh'):
        stream_map(fn, dat, mesh=mesh, device='meta')


# --- the Dataset surface -----------------------------------------------------

def test_from_dataset_mesh_shards_the_leading_batch_dim(mesh, jmesh):
    ds = dataset(ny=8, nx=5)
    fields, dims = tx.from_dataset(ds, mesh=mesh, dtype=np.float64)
    jfields, jdims = jx.from_dataset(ds, mesh=jmesh)
    plain, _ = tx.from_dataset(ds, dtype=np.float64)
    assert dims == jdims == ('y', 'x') and set(fields) == set(jfields)
    for k, v in fields.items():
        assert isinstance(v, Sharded) and v.shape == jfields[k].shape
        assert {tuple(s.shape) for s in v.shards.values()} == {
            s.data.shape for s in jfields[k].addressable_shards}
        np.testing.assert_array_equal(v.numpy(), plain[k])
    # Subset-dim variables cover the full batch before the split.
    mixed, _ = tx.from_dataset(dataset('mixed', ny=8, nx=5), mesh=mesh)
    assert mixed['pressure'].shape == (8, 5, 16)
    with pytest.raises(ValueError, match='does not divide the leading'):
        tx.from_dataset(dataset(ny=5, nx=7), mesh=mesh)
    column = tx.xr.Dataset({'pressure': (('model_level_number',),
                                         np.linspace(1000.0, 200.0, 16))})
    with pytest.raises(ValueError, match='LEVEL'):
        tx.from_dataset(column, mesh=mesh)


@pytest.mark.parametrize('name', ['conv_properties_fused',
                                  'min_conv_properties'])
def test_dataset_pipeline_with_mesh_on_an_uneven_grid(mesh, jmesh, tables,
                                                      name):
    """35 columns over 8 entries: padded, sharded, computed, sliced."""
    ds = dataset(ny=5, nx=7)
    kw = dict(tables=tables, dtype=np.float64)
    whole = getattr(tx, name)(ds, device='cpu', **kw)
    got = getattr(tx, name)(ds, mesh=mesh, **kw)
    streamed = getattr(tx, name)(ds, mesh=mesh, stream_columns=12, **kw)
    for out in (got, streamed):
        assert_meta_same(whole, out, name)
        for k in whole.data_vars:
            assert values(out[k]).shape == (5, 7)
            assert_scaled(values(whole[k]), values(out[k]),
                          name=f'{name}/{k}')
    # The JAX surface with its mesh (float32 lowering, float64 tables).
    want = getattr(jx, name)(ds, mesh=jmesh)
    got32 = getattr(tx, name)(ds, mesh=mesh, tables=AdiabatTables(
        tables.coeffs.float()))
    assert_meta_same(want, got32, name)
    for k in want.data_vars:
        assert_f32_budget(values(want[k]), values(got32[k]), f'{name}/{k}')


def test_dataset_mesh_errors(mesh, tables):
    column = tx.xr.Dataset({
        k: (('model_level_number',), np.linspace(1000.0, 200.0, 16))
        for k in ('pressure', 'temperature', 'specific_humidity',
                  'height_asl', 'wind_u', 'wind_v',
                  'wind_height_above_surface')})
    with pytest.raises(ValueError, match='need at least one non-vertical'):
        tx.conv_properties_fused(column, mesh=mesh, tables=tables)
    with pytest.raises(ValueError, match='is not in the mesh'):
        tx.conv_properties_fused(dataset(), mesh=mesh, device='meta',
                                 tables=tables)
    # The mesh's device named as well: accepted.
    out = tx.min_conv_properties_fused(dataset(), mesh=mesh, device='cpu',
                                       tables=tables, dtype=np.float64)
    assert values(out['mixed_100_cape']).shape == (3, 4)


# --- the entry-point file and two processes ----------------------------------

def test_graft_entry_dryrun_multichip(capsys, jax_tables):
    import __graft_entry_torch__ as entry
    # The JAX package's cached coefficients: the defaults would be built on
    # the CPU first, which takes minutes there.
    tab32 = AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                     torch.float32)
    entry.dryrun_multichip(8, tables=tab32)
    assert 'dryrun_multichip OK: 8 mesh entries' in capsys.readouterr().out
    fn, args = entry.entry(device='cpu', tables=tab32)
    cape, cin = fn(*args)
    assert cape.shape == cin.shape == (256,) and torch.isfinite(cape).any()


def test_two_process_global_mesh(tmp_path, tables):
    """Two gloo processes of four host entries each, one global mesh: each
    rank's shards equal the single-process result computed here, the
    poisoned level stays NaN, ``global_stats`` crosses the process
    boundary, a streamed run is gathered, and a mesh artifact serves an
    uneven batch."""
    dat = _make_grid()
    ref = tpipeline.conv_properties(tensors(dat), tables=tables)
    ref = {k: v.numpy() for k, v in ref.items()}
    assert np.isfinite(ref['mu_cape']).any() and np.isnan(ref['mu_cape'][3])
    minref = {k: v.numpy() for k, v in tpipeline.min_conv_properties(
        tensors(dat), tables=tables).items()}
    path = tmp_path / 'grid.npz'
    np.savez(path, coeffs=tables.coeffs.numpy(),
             **{f'in_{k}': v for k, v in dat.items()},
             **{f'out_{k}': v for k, v in ref.items()},
             **{f'minout_{k}': v for k, v in minref.items()})
    port = _free_port()
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'distributed_worker_torch.py'),
         str(i), '2', str(port), str(path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {i} failed:\n{out}'
        assert f'[worker {i}] OK' in out, out
        assert '8 global entries' in out, out
        assert f'[worker {i}] serving OK' in out, out
