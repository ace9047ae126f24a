"""Tier-2 serial-vs-vector comparison through the port's ``api``.

The port's counterpart of ``tests/test_serial_extended.py``: the
reference's full acceptance set (most-unstable and mixed-layer CAPE/CIN,
three lifted indices, DCIs, both wet bulbs, bulk shear and the height
diagnostics) computed by the port's array facade on CPU tensors and diffed
per column against the serial scipy oracle ``tests/serial_oracle.py``, with
the logic-identical exact-ODE backend (<= 1e-4 J/kg on same-branch columns)
and NaN-pattern equality.  The oracle is imported by the tests only.
"""

import numpy as np
import pytest
import torch

from xarray_parcel_tpu_torch import api

import serial_oracle as oracle
from test_integration_serial import make_grid

ML = dict(moist_lapse=api.moist_lapse_integrate)


def tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope='module')
def grid():
    return make_grid(ny=6, nx=6, L=48, seed=11)


@pytest.fixture(scope='module')
def winds(grid):
    p = grid[0]
    rng = np.random.default_rng(12)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    return {
        'su': rng.normal(3, 2, p.shape[:-1]),
        'sv': rng.normal(0, 2, p.shape[:-1]),
        'wu': rng.normal(8, 5, p.shape),
        'wv': rng.normal(2, 5, p.shape),
        'h': h - h[..., :1],
    }


@pytest.fixture(scope='module')
def vector(grid):
    p, t, td = tensors(*grid)
    mu_cc, mu_prof, mu_parcel = api.most_unstable_cape_cin(
        p, t, td, depth=250.0, **ML)
    m100_cc, m100_prof, _ = api.mixed_layer_cape_cin(
        p, t, td, depth=100.0, **ML)
    m50_cc, m50_prof, _ = api.mixed_layer_cape_cin(
        p, t, td, depth=50.0, **ML)
    out = {}
    for name, cc, prof in (('mu', mu_cc, mu_prof),
                           ('m100', m100_cc, m100_prof),
                           ('m50', m50_cc, m50_prof)):
        li = api.lifted_index(prof)['lifted_index']
        out[f'{name}_cape'] = cc['cape']
        out[f'{name}_cin'] = cc['cin']
        out[f'{name}_lfc'] = prof['lfc_pressure']
        out[f'{name}_li'] = li
        out[f'{name}_dci'] = api.deep_convective_index(p, t, td, li)['dci']
    out['mu_parcel_pressure'] = mu_parcel['pressure']
    out['wb_exact'] = api.wet_bulb_temperature(p, t, td)
    out['wb_fast'] = api.wet_bulb_temperature_fast(t, td)
    return {k: v.numpy() for k, v in out.items()}

@pytest.fixture(scope='module')
def serial(grid):
    p, t, td = grid
    ny, nx, _ = p.shape
    keys = [f'{n}_{v}' for n in ('mu', 'm100', 'm50')
            for v in ('cape', 'cin', 'lfc', 'li', 'dci')]
    keys.append('mu_parcel_pressure')
    out = {k: np.full((ny, nx), np.nan) for k in keys}
    for i in range(ny):
        for j in range(nx):
            col = (p[i, j], t[i, j], td[i, j])
            mu = oracle.most_unstable_cape_cin_column(*col, depth=250.0)
            m100 = oracle.mixed_layer_cape_cin_column(*col, depth=100.0)
            m50 = oracle.mixed_layer_cape_cin_column(*col, depth=50.0)
            out['mu_parcel_pressure'][i, j] = mu['parcel_pressure']
            for name, res in (('mu', mu), ('m100', m100), ('m50', m50)):
                li = oracle.lifted_index_column(res)
                out[f'{name}_cape'][i, j] = res['cape']
                out[f'{name}_cin'][i, j] = res['cin']
                out[f'{name}_lfc'][i, j] = res['lfc']
                out[f'{name}_li'][i, j] = li
                out[f'{name}_dci'][i, j] = oracle.dci_column(*col, li)
    return out


def _same_branch(a, b, tol=1.0):
    both_nan = np.isnan(a) & np.isnan(b)
    both_fin = ~np.isnan(a) & ~np.isnan(b)
    return both_nan | (both_fin & (np.abs(np.where(both_fin, a - b, 0.0))
                                   < tol))


@pytest.mark.parametrize('name', ['mu', 'm100', 'm50'])
def test_parcel_variant_vs_serial(vector, serial, name):
    if name == 'mu':
        # The variant is only comparable where both sides picked the same
        # parcel (theta-e argmax ties are fp-order sensitive).
        same_parcel = np.abs(vector['mu_parcel_pressure'] -
                             serial['mu_parcel_pressure']) < 1e-6
        assert same_parcel.mean() > 0.9
    else:
        same_parcel = np.ones_like(vector[f'{name}_cape'], bool)
    same = same_parcel & _same_branch(vector[f'{name}_lfc'],
                                      serial[f'{name}_lfc'])
    assert same.mean() > 0.85, f'{name}: only {same.mean():.0%} same-branch'
    for v, tol in (('cape', 1e-4), ('cin', 1e-4), ('li', 1e-5),
                   ('dci', 1e-5)):
        a, b = vector[f'{name}_{v}'][same], serial[f'{name}_{v}'][same]
        both = ~np.isnan(a) & ~np.isnan(b)
        # NaN patterns agree on same-branch columns.
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f'{name}_{v} NaN pattern')
        d = np.abs(a[both] - b[both])
        assert d.size and d.max() < tol, (
            f'{name}_{v}: max diff {d.max() if d.size else "empty"}')


def test_wet_bulbs_vs_serial(grid, vector):
    p, t, td = grid
    wb = vector['wb_exact']
    assert np.isfinite(wb).mean() > 0.95        # envelope covers the grid
    # Spot-check a stratified sample serially (every column, 6 levels).
    for i in range(p.shape[0]):
        for j in range(p.shape[1]):
            for k in range(0, p.shape[2], 8):
                if not np.isfinite(wb[i, j, k]):
                    continue
                ref = oracle.wet_bulb_exact_point(p[i, j, k], t[i, j, k],
                                                  td[i, j, k])
                assert abs(wb[i, j, k] - ref) < 2e-4, (i, j, k)
    fast = vector['wb_fast']
    ref_fast = oracle.wet_bulb_fast_point(t, td)
    np.testing.assert_allclose(fast, ref_fast, atol=1e-6)


def test_wind_shear_vs_serial(grid, winds):
    out = api.wind_shear(*tensors(winds['su'], winds['sv'], winds['wu'],
                                  winds['wv'], winds['h']))
    out = {k: v.numpy() for k, v in out.items()}
    ny, nx = winds['su'].shape
    for i in range(ny):
        for j in range(nx):
            ref = oracle.wind_shear_column(
                winds['su'][i, j], winds['sv'][i, j], winds['wu'][i, j],
                winds['wv'][i, j], winds['h'][i, j])
            for k in ('shear_u', 'shear_v', 'shear_magnitude'):
                assert abs(out[k][i, j] - ref[k]) < 1e-6, (k, i, j)
            assert bool(out['positive_shear'][i, j]) == ref['positive_shear']


def test_height_diagnostics_vs_serial(grid):
    """Lapse rate, T500, freezing and (fast) melting level: the rest of
    the reference's serial comparison set."""
    p, t, td = grid
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    tp, tt, ttd, th = tensors(p, t, td, h)
    lapse = api.lapse_rate(tp, tt, th).numpy()
    t500 = api.isobar_temperature(tp, tt, 500.0).numpy()
    flh = api.freezing_level_height(tt, th).numpy()
    mlh = api.melting_level_height(tp, tt, ttd, th, fast=True)[0].numpy()
    ny, nx, _ = p.shape
    for i in range(ny):
        for j in range(nx):
            assert abs(lapse[i, j] - oracle.lapse_rate_column(
                p[i, j], t[i, j], h[i, j])) < 1e-8
            assert abs(t500[i, j] - oracle.isobar_temperature_column(
                p[i, j], t[i, j])) < 1e-8
            ref = oracle.freezing_level_height_column(t[i, j], h[i, j])
            assert (np.isnan(flh[i, j]) and np.isnan(ref)) or \
                abs(flh[i, j] - ref) < 1e-6, (i, j)
            ref = oracle.melting_level_height_fast_column(
                t[i, j], td[i, j], h[i, j])
            assert (np.isnan(mlh[i, j]) and np.isnan(ref)) or \
                abs(mlh[i, j] - ref) < 1e-6, (i, j)


def test_mixed_parcel_interior_nan_vs_serial():
    """Interior whole-level NaNs inside the mixing layer: the vector
    mixed_parcel bridges them (dropna-then-trapezoid), exactly what the
    serial oracle's p[sel]-then-pairwise-trapz computes."""
    p, t, td = make_grid(ny=4, nx=4, L=48, seed=23)
    p, t, td = p.copy(), t.copy(), td.copy()
    rng = np.random.default_rng(5)
    # Poison 1-2 whole levels inside the lowest 100 hPa of most columns.
    for i in range(4):
        for j in range(4):
            if (i + j) % 3 == 0:
                continue                      # keep some NaN-free columns
            for k in rng.choice(range(1, 5), size=rng.integers(1, 3),
                                replace=False):
                p[i, j, k] = t[i, j, k] = td[i, j, k] = np.nan

    mp = api.mixed_parcel(*tensors(p, t, td))
    for i in range(4):
        for j in range(4):
            p0, mt, mtd = oracle.mixed_parcel_column(p[i, j], t[i, j],
                                                     td[i, j])
            np.testing.assert_allclose(
                float(mp['pressure'][i, j]), p0, atol=1e-9,
                err_msg=f'col {i},{j} pressure')
            np.testing.assert_allclose(
                float(mp['temperature'][i, j]), mt, atol=1e-8,
                err_msg=f'col {i},{j} temperature')
            np.testing.assert_allclose(
                float(mp['dewpoint'][i, j]), mtd, atol=1e-7,
                err_msg=f'col {i},{j} dewpoint')
