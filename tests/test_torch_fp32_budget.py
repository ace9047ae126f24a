"""The port's float32 error budget, as ``test_fp32_budget.py`` holds the
JAX package's: float32 against the float64 path of the same code on the
same grids.

The surface solve on ``make_grid`` (modular and fused, the kernel's plain
twin): p95 of |CAPE|/|CIN| error < 1 J/kg and branch flips (> 5 J/kg) under
5%.  The whole ``conv_properties_fused`` with the storm proxies on the
regression archive's inputs: per output, NaN flips <= 1%, relative error
(of the output's float64 scale) p95 <= 1e-4 and max <= 5e-4, proxy flips
<= 5%.  The port's float64 surface solve is also held to the JAX
package's on the grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu_torch import AdiabatTables, cape, fused, pipeline

import chip_smoke
from make_regression_archive import make_inputs


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables64(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


@pytest.fixture(scope='module')
def grid():
    return chip_smoke.make_grid()


def _cape(grid, dtype, tables, fn):
    res, _ = fn(*(torch.as_tensor(x, dtype=dtype) for x in grid),
                tables=tables)
    return res['cape'].double().numpy(), res['cin'].double().numpy()


def test_fp32_cape_budget(tables64, grid):
    cape64, cin64 = _cape(grid, torch.float64, tables64,
                          cape.surface_based_cape_cin)
    tables32 = tables64.astype(torch.float32)
    for name, fn in (('modular', cape.surface_based_cape_cin),
                     ('fused', fused.fused_surface_cape_cin)):
        cape32, cin32 = _cape(grid, torch.float32, tables32, fn)
        assert not np.isnan(cape32).all()
        for q, a64, a32 in (('cape', cape64, cape32), ('cin', cin64, cin32)):
            d = np.abs(a32 - a64)
            bulk = np.nanquantile(d, 0.95)
            flips = np.mean(d > 5.0)
            assert bulk < 1.0, f'{name}/{q}: p95 fp32 error {bulk:.3f} J/kg'
            assert flips < 0.05, f'{name}/{q}: {flips:.1%} branch flips'


def test_fp32_full_pipeline_budget(tables64):
    inputs = make_inputs()

    def run(dtype, tables):
        dat = {k: torch.as_tensor(v, dtype=dtype) for k, v in inputs.items()}
        out = pipeline.conv_properties_fused(dat, tables=tables)
        out.update(pipeline.storm_proxies(out))
        return {k: v.numpy() for k, v in out.items()}

    out64 = run(torch.float64, tables64)
    out32 = run(torch.float32, tables64.astype(torch.float32))
    assert set(out64) == set(out32) and len(out64) > 20
    for k in sorted(out64):
        a, b = out64[k], out32[k]
        if a.dtype == bool:
            flips = np.mean(a != b.astype(bool))
            assert flips <= 0.05, f'{k}: {flips:.1%} proxy flips'
            continue
        b = b.astype(np.float64)
        nanflips = np.mean(np.isnan(a) != np.isnan(b))
        assert nanflips <= 0.01, f'{k}: {nanflips:.1%} NaN-pattern flips'
        both = ~np.isnan(a) & ~np.isnan(b)
        if not both.any():
            continue
        scale = max(1.0, float(np.nanmax(np.abs(a))))
        d = np.abs(a[both] - b[both]) / scale
        p95 = float(np.quantile(d, 0.95))
        assert p95 <= 1e-4, f'{k}: p95 rel err {p95:.2e} > 1e-4'
        assert float(d.max()) <= 5e-4, f'{k}: max rel err {d.max():.2e}'


def test_port_matches_jax_in_float64(tables64, jax_tables, grid):
    want, _ = jcape.surface_based_cape_cin(*(jnp.asarray(x) for x in grid),
                                           tables=jax_tables)
    got = dict(zip(('cape', 'cin'), _cape(grid, torch.float64, tables64,
                                         cape.surface_based_cape_cin)))
    assert not chip_smoke.exact_misses(
        'grid vs JAX', {k: np.asarray(want[k]).reshape(-1) for k in got},
        {k: v.reshape(-1) for k, v in got.items()}, rel=1e-9)
