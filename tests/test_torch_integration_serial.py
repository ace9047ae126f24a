"""The port through the tier-2 integration test of
``test_integration_serial.py``: surface-based CAPE/CIN, LFC and EL on a
convective grid against the serial per-column oracle.

The same grids (``chip_smoke.make_grid``, default and seed 23) and the same
tolerances: with the exact-ODE backend the two sides are logic-identical
(NaN patterns of LFC/EL equal, > 95% of columns on the same LFC branch,
CAPE/CIN within 1e-4 J/kg there); with the tables the residual is table
error only (CAPE within 1 J/kg or 1%).  The port's exact-ODE results are
also held to the JAX package's on the same grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu_torch import AdiabatTables, adiabat, cape

import chip_smoke
import serial_oracle as oracle

ML = dict(moist_lapse=adiabat.moist_lapse_integrate)


@pytest.fixture(scope='module')
def grid():
    return chip_smoke.make_grid()


@pytest.fixture(scope='module')
def serial(grid):
    p, t, td = grid
    ny, nx, _ = p.shape
    out = {k: np.empty((ny, nx)) for k in ('cape', 'cin', 'lfc', 'el')}
    for i in range(ny):
        for j in range(nx):
            c, n, lfc, el = oracle.surface_cape_cin_column(
                p[i, j], t[i, j], td[i, j])
            out['cape'][i, j] = c
            out['cin'][i, j] = n
            out['lfc'][i, j] = lfc
            out['el'][i, j] = el
    return out


def run_vector(grid, **kw):
    res, prof = cape.surface_based_cape_cin(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in grid), **kw)
    return {'cape': res['cape'].numpy(), 'cin': res['cin'].numpy(),
            'lfc': prof['lfc_pressure'].numpy(),
            'el': prof['el_pressure'].numpy()}


def test_vector_vs_serial_logic_identical(grid, serial):
    vec = run_vector(grid, **ML)
    for k in ('lfc', 'el'):
        np.testing.assert_array_equal(np.isnan(vec[k]), np.isnan(serial[k]),
                                      err_msg=f'NaN pattern mismatch: {k}')
    same_branch = chip_smoke.same_branch(vec['lfc'], serial['lfc'])
    assert same_branch.mean() > 0.95
    for k, tol in (('cape', 1e-4), ('cin', 1e-4)):
        d = np.abs(vec[k] - serial[k])[same_branch]
        assert np.nanmax(d) < tol, f'{k} max diff {np.nanmax(d)}'


def test_vector_tables_vs_serial(grid, serial):
    tables = AdiabatTables.from_numpy(
        np.asarray(jad.load_moist_adiabat_lookups().coeffs), 'cpu',
        torch.float64)
    vec = run_vector(grid, tables=tables)
    same_branch = chip_smoke.same_branch(vec['lfc'], serial['lfc'])
    assert same_branch.mean() > 0.95
    d = np.abs(vec['cape'] - serial['cape'])[same_branch]
    rel = d / np.maximum(np.abs(serial['cape'])[same_branch], 100.0)
    assert np.nanmax(np.minimum(d, rel * 100.0)) < 1.0, (
        f'cape table error: max abs {np.nanmax(d)}')


def test_vector_vs_serial_second_seed():
    grid2 = chip_smoke.make_grid(ny=5, nx=5, L=56, seed=23)
    p, t, td = grid2
    vec = run_vector(grid2, **ML)
    for i in range(5):
        for j in range(5):
            c, n, lfc, el = oracle.surface_cape_cin_column(
                p[i, j], t[i, j], td[i, j])
            same = (np.isnan(vec['lfc'][i, j]) and np.isnan(lfc)) or \
                (abs(vec['lfc'][i, j] - lfc) < 1.0)
            if not same:
                continue          # legitimate multi-LFC ambiguity
            assert abs(vec['cape'][i, j] - c) < 1e-4, (i, j)
            assert abs(vec['cin'][i, j] - n) < 1e-4, (i, j)


def test_port_matches_jax_on_the_grid(grid):
    res, prof = jax.jit(lambda p, t, td: jcape.surface_based_cape_cin(
        p, t, td, moist_lapse=jad.moist_lapse_integrate))(
            *(jnp.asarray(x) for x in grid))
    want = {'cape': res['cape'], 'cin': res['cin'],
            'lfc': prof['lfc_pressure'], 'el': prof['el_pressure']}
    got = run_vector(grid, **ML)
    assert not chip_smoke.exact_misses(
        'grid vs JAX', {k: np.asarray(v).reshape(-1) for k, v in want.items()},
        {k: v.reshape(-1) for k, v in got.items()}, rel=1e-9)
