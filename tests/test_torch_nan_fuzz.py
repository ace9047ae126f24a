"""The port through the NaN-pattern fuzz of ``test_nan_fuzz.py``: the
fused solve (the kernel's plain twin) against the modular path under
adversarial NaN patterns -- top padding, interior poisoned temperatures and
dewpoints, all-NaN columns, a NaN parcel state -- and the all-NaN grid.

The same grids and seeds (``chip_smoke.nan_fuzz_grid``), the same
comparison: identical NaN patterns and 1e-6 absolute on CAPE, CIN and the
LFC/EL pressures; CAPE/CIN exactly equal on the all-NaN grid.  Seed 0 is
also held to the JAX package's modular path on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu_torch import AdiabatTables, cape, fused

import chip_smoke


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


def tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fused_matches_xla_under_nan_fuzz(tables, seed):
    p, t, td = tensors(*chip_smoke.nan_fuzz_grid(seed))
    res_f, sol_f = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    res_u, prof = cape.surface_based_cape_cin(p, t, td, tables=tables)
    for got, want, keys in ((res_f, res_u, ('cape', 'cin')),
                            (sol_f, prof, ('lfc_pressure', 'el_pressure'))):
        for k in keys:
            a, b = got[k].numpy(), want[k].numpy()
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=f'NaN pattern: {k} '
                                                  f'seed={seed}')
            np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                       atol=1e-6, err_msg=f'{k} seed={seed}')


def test_all_nan_grid(tables):
    p = torch.from_numpy(chip_smoke.all_nan_grid())
    res_f, _ = fused.fused_surface_cape_cin(p, p, p, tables=tables)
    res_u, _ = cape.surface_based_cape_cin(p, p, p, tables=tables)
    for k in ('cape', 'cin'):
        # All-NaN input -> CAPE/CIN 0 on both paths (no LFC exists).
        np.testing.assert_array_equal(res_f[k].numpy(), res_u[k].numpy())
        assert (res_f[k] == 0).all(), k


def test_port_matches_jax_under_nan_fuzz(tables, jax_tables):
    grid = chip_smoke.nan_fuzz_grid(0)
    want, wprof = jcape.surface_based_cape_cin(
        *(jnp.asarray(x) for x in grid), tables=jax_tables)
    got, gprof = cape.surface_based_cape_cin(*tensors(*grid), tables=tables)
    keys = ('lfc_pressure', 'el_pressure')
    assert not chip_smoke.exact_misses(
        'nan fuzz vs JAX', {**{k: np.asarray(want[k]) for k in want},
                            **{k: np.asarray(wprof[k]) for k in keys}},
        {**got, **{k: gprof[k] for k in keys}}, rel=1e-9)
