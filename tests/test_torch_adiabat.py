"""The port's moist-adiabat engine against the JAX package.

The port builds its own spectral coefficients (``build_spectral``); they
must evaluate to the JAX cache's curves within 1e-9 K on the 0.5 hPa grid.
The evaluation half (curve index, row blend, Clenshaw series) is held to the
JAX functions on the same coefficients.  The table functions
(``generate_curves``, ``build_lookup``) are held to the JAX package's
cached curves (1e-9 K) and lookup table (identical NaN cells, 1e-6 index
units); table files cross between the packages in both directions, and
``load_moist_adiabat_lookups`` caches in the port's own file.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu_torch import adiabat as tad
from xarray_parcel_tpu_torch import AdiabatTables
from xarray_parcel_tpu_torch import constants as tc

from test_torch_ops import assert_same, to_torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'xarray_parcel_tpu_torch', 'csrc')


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def port_coeffs():
    return tad.build_spectral('cpu')


@pytest.mark.parametrize('name', ['P_TOP', 'P_BOT', 'T_MIN', 'T_MAX_EXCL',
                                  'T_STEP', 'N_TEMP', 'N_CURVES',
                                  'CURVE_OFFSET', 'N_SEG', 'SEG_K', 'N_COEF',
                                  'SEG_SPLITS', '_LNP_LO', '_LNP_HI',
                                  '_SEG_LNP'])
def test_grid_constants(name):
    assert getattr(tad, name) == getattr(jad, name)


def test_curve_start_temperatures_and_chebyshev_helpers():
    np.testing.assert_array_equal(
        tad.curve_start_temperatures('cpu').numpy(),
        np.asarray(jad.curve_start_temperatures()))
    for n in (5, 14):
        for a, b in zip(tad._cheb_nodes(n), jad._cheb_nodes(n)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tad._cheb_transform_matrix(n),
                                      jad._cheb_transform_matrix(n))


def test_rk4_and_integrate_between():
    rng = np.random.default_rng(11)
    t0 = rng.uniform(220.0, 310.0, 32)
    lp0 = np.log(rng.uniform(300.0, 1050.0, 32))
    lp1 = np.log(rng.uniform(100.0, 1100.0, 32))
    assert_same(jad.rk4_step(jnp.asarray(lp0), jnp.asarray(lp1 - lp0),
                             jnp.asarray(t0)),
                tad.rk4_step(to_torch(lp0), to_torch(lp1 - lp0),
                             to_torch(t0)))
    assert_same(jad.integrate_between(jnp.asarray(t0), jnp.asarray(lp0),
                                      jnp.asarray(lp1), n_substeps=7),
                tad.integrate_between(to_torch(t0), to_torch(lp0),
                                      to_torch(lp1), n_substeps=7))


def test_built_coefficients_match_jax_cache(jax_tables, port_coeffs):
    """Port-built and JAX-cached coefficients evaluate to the same curves
    on the 0.5 hPa table grid (every curve, in chunks)."""
    ref = torch.tensor(np.asarray(jax_tables.coeffs))
    assert port_coeffs.shape == ref.shape == (tad.N_CURVES, tad.N_COEF)
    grid = to_torch(jad.pressure_grid())
    lnp = torch.log(grid)
    worst = 0.0
    for rows in torch.arange(tad.N_CURVES).split(1430):
        lp = lnp.expand(len(rows), -1)
        a = tad._eval_spectral(port_coeffs[rows], None, log_pressure=lp)
        b = tad._eval_spectral(ref[rows], None, log_pressure=lp)
        worst = max(worst, (a - b).abs().max().item())
    assert worst <= 1e-9, worst


@pytest.mark.parametrize('with_log', [False, True])
def test_eval_spectral(jax_tables, with_log):
    rng = np.random.default_rng(12)
    coeffs = np.asarray(jax_tables.coeffs)[rng.integers(0, tad.N_CURVES, 16)]
    p = np.exp(rng.uniform(np.log(2.5), np.log(1100.0), (16, 40)))
    p[0, :3] = [50.0, 230.0, 1100.0]        # segment splits and the edge
    lp = np.log(p) if with_log else None
    want = jad._eval_spectral(
        jnp.asarray(coeffs), jnp.asarray(p),
        log_pressure=None if lp is None else jnp.asarray(lp))
    got = tad._eval_spectral(
        to_torch(coeffs), to_torch(p),
        log_pressure=None if lp is None else to_torch(lp))
    assert_same(want, got, atol=1e-10)
    with pytest.raises(ValueError):
        tad._eval_spectral(to_torch(coeffs[:, :40]), to_torch(p))


def test_curve_index_integrate():
    rng = np.random.default_rng(13)
    pp = rng.uniform(400.0, 1095.0, 64)
    pt = rng.uniform(200.0, 318.0, 64)
    pp[2] = np.nan
    pt[5] = np.nan
    pt[6] = 360.0                            # outside the curve family
    pp[7], pt[7] = 1090.0, 150.0            # below it
    pp[8] = 0.0                              # non-positive pressure
    want = jad.curve_index_integrate(jnp.asarray(pp), jnp.asarray(pt))
    got = tad.curve_index_integrate(to_torch(pp), to_torch(pt))
    assert_same(want, got, atol=1e-8)
    assert torch.isnan(got[[2, 5, 6, 7, 8]]).all()


def test_blend_coeff_rows(jax_tables):
    tables = tad.AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs),
                                          'cpu', torch.float64)
    fidx = np.array([0.0, 0.25, 17.5, 7150.0, tad.N_CURVES - 1.0,
                     tad.N_CURVES - 1.5, np.nan, 123.999])
    want = jad.blend_coeff_rows(jax_tables, jnp.asarray(fidx))
    got = tad.blend_coeff_rows(tables, to_torch(fidx))
    assert got.shape == (8, tad.N_COEF)
    assert_same(want, got, atol=1e-12)


def test_adiabat_tables_module(port_coeffs):
    tables = tad.AdiabatTables.from_numpy(port_coeffs.numpy(), 'cpu',
                                          torch.float32)
    assert isinstance(tables, torch.nn.Module)
    assert dict(tables.named_buffers())['coeffs'] is tables.coeffs
    assert tables.coeffs.dtype == torch.float32
    assert tables.to(torch.float64).coeffs.dtype == torch.float64
    with pytest.raises(ValueError):
        tad.AdiabatTables(port_coeffs[:10])


def cu_constants(*names):
    src = ''
    for name in names:
        with open(os.path.join(CSRC, name)) as f:
            src += f.read()
    return {m[0]: float(m[1]) for m in re.findall(
        r'constexpr double (k\w+) = ([-+0-9.eE]+);', src)}


def test_kernel_constants_match_python():
    """The CUDA kernels' hard-coded constants are the Python values: the
    solve's own and the shared ones of thermo.cuh."""
    k = cu_constants('fused_cape.cu', 'thermo.cuh')
    lnp = tad._SEG_LNP
    want = {
        'kRd': tc.Rd, 'kKappa': tc.kappa, 'kEpsilon': tc.epsilon,
        'kCpd': tc.Cp_d, 'kLv': tc.Lv, 'kZeroC': tc.zero_degc,
        'kSatPressure0c': tc.sat_pressure_0c,
        'kVirtualEps': tc.virtual_temperature_epsilon, 'kP0': tc.P0,
        'kPTop': tad.P_TOP, 'kPBot': tad.P_BOT,
        'kSegLnp1': lnp[1], 'kSegLnp2': lnp[2],
        **{f'kSegScale{s}': 2.0 / (lnp[s + 1] - lnp[s]) for s in range(3)},
        **{f'kSegShift{s}': (lnp[s + 1] + lnp[s]) / (lnp[s + 1] - lnp[s])
           for s in range(3)},
    }
    assert set(k) == set(want)
    for name, value in want.items():
        assert k[name] == value, name


# --- building the tables and the table files ---------------------------------

def test_round_to_and_pressure_grid():
    x = np.array([273.154, 299.996, 173.0, 250.005])
    np.testing.assert_allclose(tad.round_to(to_torch(x), 0.02).numpy(),
                               np.asarray(jad.round_to(x, 0.02)), atol=1e-12)
    np.testing.assert_array_equal(tad.pressure_grid().numpy(),
                                  np.asarray(jad.pressure_grid()))
    assert tad.pressure_grid().shape == (tad.N_PRES,)
    for a, b in zip(tad._refined_grid(), jad._refined_grid()):
        np.testing.assert_array_equal(a, b)
    assert tad.MAX_DLOGP == jad.MAX_DLOGP


def test_generate_curves_match_jax(jax_tables):
    """Every 50th curve (286 of 14,300: generate_curves walks all curves in
    step, so a subset takes the same path) against the JAX cache, 1e-9 K."""
    sel = slice(None, None, 50)
    starts = tad.curve_start_temperatures('cpu')[sel]
    curves = tad.generate_curves('cpu', starts=starts)
    want = np.asarray(jax_tables.curves)[sel]
    assert curves.shape == want.shape == (286, tad.N_PRES)
    assert curves.dtype == torch.float64
    np.testing.assert_allclose(curves.numpy(), want, atol=1e-9, rtol=0)


def test_build_lookup_matches_jax(jax_tables):
    """The lookup table from the JAX package's curves: the same NaN cells
    and fractional indices within 1e-6 (it is stored as float32)."""
    lookup = tad.build_lookup(to_torch(np.asarray(jax_tables.curves,
                                                  np.float64)))
    want = np.asarray(jax_tables.lookup)
    assert lookup.shape == want.shape == (tad.N_PRES, tad.N_TEMP)
    assert lookup.dtype == torch.float32
    assert_same(want, lookup, atol=1e-6, rtol=0, name='lookup')
    assert np.isnan(want).any() and np.isfinite(want).any()


@pytest.fixture(scope='module')
def port_tables(jax_tables, port_coeffs):
    """The port's own coefficients with curves and lookup built by the
    port (the lookup from the JAX curves: the full family takes
    too long on the CPU for a test; the subset test above covers it)."""
    curves = to_torch(np.asarray(jax_tables.curves, np.float64))
    return AdiabatTables(port_coeffs, curves, tad.build_lookup(curves))


def test_port_file_loads_into_jax(tmp_path, port_tables, jax_tables):
    """``AdiabatTables.save`` writes the JAX package's layout: its loader
    reads the file back bit for bit."""
    path = str(tmp_path / 'port_tables.npz')
    port_tables.save(path)
    assert tad._stored_dtype(path) == np.float64
    back = jad.AdiabatTables.load(path)
    for name in ('coeffs', 'curves', 'lookup'):
        a = np.asarray(getattr(back, name))
        b = getattr(port_tables, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    again = AdiabatTables.load(path, 'cpu')
    assert again.coeffs.dtype == torch.float64
    assert torch.equal(again.coeffs, port_tables.coeffs)
    assert torch.equal(again.lookup.nan_to_num(-1),
                       port_tables.lookup.nan_to_num(-1))
    narrow = AdiabatTables.load(path, 'cpu', torch.float32)
    assert narrow.curves.dtype == narrow.coeffs.dtype == torch.float32
    assert narrow.lookup.dtype == torch.float32


def test_jax_file_loads_into_port(tmp_path, jax_tables, port_coeffs):
    """A file written by the JAX package's ``AdiabatTables.save`` loads into
    the port; its coefficients agree with the port's own build (1e-9 K)."""
    path = str(tmp_path / 'jax_tables.npz')
    jax_tables.save(path)
    got = AdiabatTables.load(path, 'cpu')
    for name in ('coeffs', 'curves', 'lookup'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jax_tables, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.coeffs.numpy(), port_coeffs.numpy(),
                               atol=1e-9, rtol=0)
    # A file without coefficients: they are rebuilt on load.
    bare = str(tmp_path / 'bare.npz')
    np.savez(bare, curves=np.asarray(jax_tables.curves),
             lookup=np.asarray(jax_tables.lookup))
    rebuilt = AdiabatTables.load(bare, 'cpu')
    assert torch.equal(rebuilt.coeffs, port_coeffs)


def test_astype_and_build_signature(port_tables):
    narrow = port_tables.astype(torch.float32)
    assert narrow.coeffs.dtype == narrow.curves.dtype == torch.float32
    assert narrow.lookup is port_tables.lookup
    assert port_tables.coeffs.dtype == torch.float64      # a new object
    bare = AdiabatTables(port_tables.coeffs).astype(torch.float32)
    assert bare.curves is None and bare.lookup is None


def test_load_moist_adiabat_lookups_uses_its_own_cache(tmp_path, monkeypatch,
                                                       port_tables):
    """The entry point builds once, caches in the port's own file (never
    the JAX package's), loads it back, and feeds ``default_tables``."""
    built = []

    def fake_build(device, dtype, with_tables=False):
        built.append((str(device), dtype, with_tables))
        return port_tables.astype(dtype)

    monkeypatch.setattr(tad.AdiabatTables, 'build', staticmethod(fake_build))
    monkeypatch.setattr(tad, '_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(tad, '_LOADED', None)
    monkeypatch.setattr(tad, '_LOADED_SOURCE', None)
    monkeypatch.setattr(tad, '_DEFAULTS', {})
    monkeypatch.delenv('XPARCEL_TORCH_TABLE_CACHE', raising=False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tad.load_moist_adiabat_lookups()                 # the card by default
    tables = tad.load_moist_adiabat_lookups(device='cpu',
                                            dtype=torch.float64)
    assert built == [('cpu', torch.float64, True)]
    path = tmp_path / 'torch_adiabat_tables_f64.npz'
    assert path.exists() and sorted(os.listdir(tmp_path)) == [path.name]
    assert 'torch_' in path.name                 # not the JAX package's file
    assert tad.load_moist_adiabat_lookups(device='cpu',
                                          dtype=torch.float64) is tables
    assert tad.default_tables('cpu', torch.float64) is not None
    assert tad.default_tables('cpu', torch.float64).curves is not None
    assert tad.default_tables('cpu', torch.float32).curves.dtype == \
        torch.float32
    # A fresh process state: the file is read, nothing is built.
    monkeypatch.setattr(tad, '_LOADED', None)
    again = tad.load_moist_adiabat_lookups(device='cpu', dtype=torch.float64)
    assert len(built) == 1
    assert torch.equal(again.coeffs, tables.coeffs)
    # A float32 request is served from the wider file given explicitly.
    narrow = tad.load_moist_adiabat_lookups(cache_path=str(path),
                                            device='cpu',
                                            dtype=torch.float32)
    assert narrow.coeffs.dtype == torch.float32 and len(built) == 1
    # regenerate builds anew.
    tad.load_moist_adiabat_lookups(device='cpu', dtype=torch.float64,
                                   regenerate=True)
    assert len(built) == 2
    with pytest.raises(TypeError):
        tad.load_moist_adiabat_lookups(device='cpu', dtype=torch.float16)


def test_table_modes_run_on_the_ports_own_tables(port_tables):
    """``moist_lapse``'s table modes on tables the port built, against the
    exact integrator (0.05 K: the table's own accuracy)."""
    rng = np.random.default_rng(21)
    p = to_torch(np.linspace(1000.0, 150.0, 24) + rng.normal(0, .3, (16, 24)))
    pt = to_torch(rng.uniform(255.0, 305.0, 16))
    exact = tad.moist_lapse_integrate(p, pt, p[:, 0])
    for kw in (dict(index_mode='bilinear'), dict(index_mode='nearest'),
               dict(curve_blend=False)):
        got = tad.moist_lapse(p, pt, p[:, 0], tables=port_tables, **kw)
        assert torch.isfinite(got).all()
        assert (got - exact).abs().max() < 0.05, kw
