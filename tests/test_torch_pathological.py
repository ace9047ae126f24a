"""The port through the degenerate soundings of ``test_pathological.py``,
end to end through ``conv_properties`` and ``conv_properties_fused``:
saturated columns, an isothermal one, a strong inversion (no LFC), a very
cold parcel near the table's edge, four valid levels under NaN padding, a
superadiabatic surface layer, near-duplicate pressures and a moist tropical
column.

The same grid (``chip_smoke.pathological_grid`` and
``pathological_dataset``) and the same contracts: the fused pipeline (both
kernels' plain twins) equal to the modular path (NaN patterns and booleans
identical, values within atol 5e-6 / rtol 1e-9), CAPE >= 0 and CIN <= 0,
zero CAPE in the inversion, large CAPE in the tropics, no inf in the
sparse column, and storm proxies that are booleans (SHIP a float) and
never fire on the inversion.  The port's modular pipeline is also held to
the JAX package's on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu_torch import AdiabatTables, pipeline

import chip_smoke


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


@pytest.fixture(scope='module')
def inputs():
    return chip_smoke.pathological_dataset(*chip_smoke.pathological_grid())


@pytest.fixture(scope='module')
def outputs(tables, inputs):
    dat = {k: torch.from_numpy(v) for k, v in inputs.items()}
    ref = pipeline.conv_properties(dat, tables=tables)
    got = pipeline.conv_properties_fused(dat, tables=tables)
    return ({k: v.numpy() for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


def test_fused_matches_modular_on_pathological_grid(outputs):
    ref, got = outputs
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = got[k], ref[k]
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=5e-6, rtol=1e-9, err_msg=k)


def test_cape_cin_sign_convention(outputs):
    ref, _ = outputs
    for k in ('mu_cape', 'mixed_100_cape', 'mixed_50_cape'):
        assert np.all(ref[k][np.isfinite(ref[k])] >= 0.0), k
    for k in ('mu_cin', 'mixed_100_cin', 'mixed_50_cin'):
        assert np.all(ref[k][np.isfinite(ref[k])] <= 0.0), k


def test_inversion_column_has_zero_cape(outputs):
    ref, _ = outputs
    assert float(ref['mu_cape'][3]) == 0.0
    assert float(ref['mixed_100_cape'][3]) == 0.0


def test_tropical_column_has_large_cape(outputs):
    ref, _ = outputs
    assert float(ref['mu_cape'][8]) > 500.0


def test_sparse_column_is_finite_or_nan_not_garbage(outputs):
    ref, _ = outputs
    for k, v in ref.items():
        if v.dtype == bool:
            continue
        assert not np.any(np.isinf(v[5])), k


def test_storm_proxies_on_pathological_grid(outputs):
    ref, _ = outputs
    prox = pipeline.storm_proxies({k: torch.from_numpy(v)
                                   for k, v in ref.items()})
    assert prox
    for k, v in prox.items():
        arr = v.numpy()
        if k == 'ship':
            assert arr.dtype != bool
            continue
        assert arr.dtype == bool, k
        if k != 'proxy_Kunz2007' and k != 'proxy_Mohr2013':
            assert not arr[3], k


def test_port_matches_jax_on_pathological_grid(outputs, inputs, jax_tables):
    ref, _ = outputs
    want = jpipeline.conv_properties(
        {k: jnp.asarray(v) for k, v in inputs.items()}, tables=jax_tables)
    assert not chip_smoke.exact_misses(
        'pathological vs JAX', {k: np.asarray(v) for k, v in want.items()},
        ref, rel=1e-9)
