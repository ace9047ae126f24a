"""The port through the randomized differential sweep of
``test_pipeline_fuzz.py``: the whole ``conv_properties`` variable set
against the serial oracle on five adversarial grid classes.

The same grids and seeds (``chip_smoke.sweep_columns``, held equal to the
JAX fixture's by ``test_torch_tier_inputs.py``), the same comparability
filters (``chip_smoke.sweep_comparable``: same parcel, same LFC/EL branch,
NaN runs outside the integration windows, the duplicated-level knife
edges) and the same tolerances, on the port's float64 CPU path:

- the modular path with ``moist_lapse_integrate`` against the oracle
  (1e-4 J/kg CAPE/CIN, 1e-5 K LI/DCI; the scalar diagnostics 1e-6, shear
  1e-8), the oracle fed the pipeline's own derived dewpoint;
- the fused pipeline (the plain twins of both kernels) equal to the modular
  path on the same tables at 1e-10 of each output's scale, with identical
  NaN and boolean patterns;
- the fused pipeline against the oracle under the table tier's tolerance
  (``test_integration_serial``: CAPE within 1 J/kg or 1%), on the same
  comparable columns;
- on the ``combined`` class, the port's modular pipeline against the JAX
  package's on the same inputs at 1e-9 of scale.

The oracle runs once per class, in the module fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu_torch import AdiabatTables, adiabat, pipeline

import chip_smoke

ML = dict(moist_lapse=adiabat.moist_lapse_integrate)
CASES = chip_smoke.SWEEP_CASES
N = chip_smoke.SWEEP_N


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


@pytest.fixture(scope='module', params=CASES)
def sweep(request, tables):
    case = request.param
    p, t, td0, h, winds = chip_smoke.sweep_columns(case)
    dat, td = chip_smoke.sweep_inputs(p, t, td0, h, winds)
    vec = chip_smoke.sweep_vector(dat, **ML)
    ser = chip_smoke.sweep_serial(p, t, td, h, winds)
    nan_pmax, dup_p = chip_smoke.sweep_records(p)
    modular = pipeline.conv_properties(dat, tables=tables, ignore_nans=True)
    fused = pipeline.conv_properties_fused(dat, tables=tables,
                                           ignore_nans=True)
    return dict(case=case, p=p, dat=dat, vec=vec, ser=ser,
                nan_pmax=nan_pmax, dup_p=dup_p, modular=modular, fused=fused)


@pytest.mark.parametrize('name', ['mu', 'm100', 'm50'])
def test_parcel_variants_vs_serial(sweep, name):
    s = sweep
    same = chip_smoke.sweep_comparable(name, s['p'], s['vec'], s['ser'],
                                       s['nan_pmax'], s['dup_p'])
    assert same.mean() > 0.6, (
        f'{s["case"]}/{name}: only {same.mean():.0%} comparable')
    chip_smoke.check_sweep_variant(s['case'], name, s['vec'], s['ser'], same)


def test_scalar_diagnostics_vs_serial(sweep):
    """Lapse rate, T500, freezing and melting level and shear: NaN patterns
    on NaN-free columns, values where both are finite, 1e-6 (shear 1e-8);
    the fused pipeline's (the tail's twin) as well."""
    for name, out in (('modular', sweep['vec']),
                      ('fused', {k: v.numpy()
                                 for k, v in sweep['fused'].items()})):
        chip_smoke.check_sweep_scalars(f'{sweep["case"]} {name}', out,
                                       sweep['ser'], sweep['nan_pmax'])


def test_fused_matches_modular_on_adversarial_grids(sweep):
    """The fused pipeline (both kernels' plain twins) and the modular path
    on the same tables: identical NaN and boolean patterns, float64
    agreement at 1e-10 of each output's scale."""
    assert len(sweep['modular']) > 20
    misses = chip_smoke.exact_misses(sweep['case'], sweep['modular'],
                                     sweep['fused'])
    assert not misses, f'{sweep["case"]}: {misses}'


def test_fused_vs_serial(sweep):
    """The fused pipeline against the oracle under the table tier's
    tolerance, on the columns the sweep compares."""
    s = sweep
    fused = {k: v.numpy() for k, v in s['fused'].items()}
    for name, _ in chip_smoke.SWEEP_PROBES:
        same = chip_smoke.sweep_comparable(name, s['p'], s['vec'], s['ser'],
                                           s['nan_pmax'], s['dup_p'])
        chip_smoke.check_sweep_variant(f'{s["case"]} fused', name, fused,
                                       s['ser'], same, tables=True)


def test_port_matches_jax_on_the_combined_grid(tables, jax_tables):
    dat, _ = chip_smoke.sweep_inputs(*chip_smoke.sweep_columns('combined'))
    got = pipeline.conv_properties(dat, tables=tables, ignore_nans=True)
    jdat = {k: jnp.asarray(v.numpy()) for k, v in dat.items()}
    want = jpipeline.conv_properties(jdat, tables=jax_tables,
                                     ignore_nans=True)
    misses = chip_smoke.exact_misses(
        'combined vs JAX', {k: np.asarray(v) for k, v in want.items()}, got,
        rel=1e-9)
    assert not misses, misses


def test_sweep_grids_are_adversarial(sweep):
    case, p, vec = sweep['case'], sweep['p'], sweep['vec']
    if case == 'dup_pressure':
        assert (np.diff(p, axis=-1) == 0).any(axis=-1).all()
    elif case == 'interior_nan':
        assert np.isnan(p).any(axis=-1).sum() >= N // 2
        assert not np.isnan(p[:, 0]).any() and not np.isnan(p[:, -1]).any()
    elif case in ('near_envelope', 'deep_depression'):
        assert np.isfinite(vec['mu_cape']).any()
    elif case == 'combined':
        assert any(len(d) for d in sweep['dup_p'])
        assert (sweep['nan_pmax'] > 0).any()
        assert np.isfinite(vec['mu_cape']).any()
