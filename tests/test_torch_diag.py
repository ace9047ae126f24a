"""The port's diagnostics tail, lifted index, SHIP and storm proxies against
the JAX package.

The tail's plain twin (``diagnostics._diag_body``, which CPU tensors reach
through ``diag_kernel``) is held to the JAX package's ``_diag_body`` and to
its Pallas kernel ``diag_fused`` in interpret mode
(``benchmarks/diag_kernel_ab.py``, imported as it is), on columns with the
hard cases of ``chip_smoke.tail_columns``.  Everything is float64; values
agree to ``assert_same``'s 1e-9 with identical NaN patterns, booleans
exactly.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import diagnostics as jdiag
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu_torch import diagnostics as tdiag
from xarray_parcel_tpu_torch import pipeline as tpipeline

from test_torch_ops import assert_same, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (REPO, os.path.join(REPO, 'benchmarks'))
                if p not in sys.path]

import chip_smoke  # noqa: E402
import diag_kernel_ab as jtail  # noqa: E402

OUTPUTS = tdiag.DIAG_OUTPUTS


def both_tails(jfn, tfn, cols, **kw):
    want = jfn(*(jnp.asarray(c) for c in cols), **kw)
    got = tfn(*(to_torch(c) for c in cols))
    return [np.asarray(w) for w in want], got


@pytest.fixture(scope='module')
def body():
    """Both twins on 40 hard columns of 30 levels."""
    return both_tails(jtail._diag_body, tdiag._diag_body,
                      chip_smoke.tail_columns(40, L=30, seed=13))


@pytest.mark.parametrize('i', range(len(OUTPUTS)), ids=OUTPUTS)
def test_diag_body_matches_jax(body, i):
    want, got = body
    assert got[i].shape == (40,) and got[i].dtype == torch.float64
    assert_same(want[i], got[i], name=OUTPUTS[i])


@pytest.mark.parametrize('L', [33, 137])
def test_diag_body_matches_jax_at_lane_edges(L):
    """Widths around the wrap of the warp that strides over a column on the
    card, on columns whose anchor levels, 0 C crossings and NaN levels
    straddle levels 31/32 and 63/64 (``chip_smoke.lane_edge_tail_columns``):
    the twin that judges the tail kernel there, held to JAX."""
    want, got = both_tails(jtail._diag_body, tdiag._diag_body,
                           chip_smoke.lane_edge_tail_columns(40, L=L, seed=L))
    for i, name in enumerate(OUTPUTS):
        assert got[i].shape == (40,)
        assert_same(want[i], got[i], name=name)


def test_tail_cases_are_exercised(body):
    _, got = body
    t850, _, lapse, t500, flh, mlh = got
    assert torch.isnan(t500).sum() >= 3            # tops below 500 hPa
    assert torch.isnan(flh).sum() >= 3             # no 0 C crossing
    assert torch.isfinite(flh).sum() > 20 and torch.isfinite(mlh).sum() > 20
    assert torch.isnan(t850).sum() >= 3            # NaN T at the anchor


@pytest.fixture(scope='module')
def interpreted():
    """The port against the JAX package's Pallas tail kernel, interpret
    mode, at its fixed (256, 90) block."""
    return both_tails(jtail.diag_fused, tdiag.diag_fused,
                      chip_smoke.tail_columns(jtail.TB, L=jtail.L, seed=17),
                      interpret=True)


@pytest.mark.parametrize('i', range(len(OUTPUTS)), ids=OUTPUTS)
def test_tail_matches_jax_kernel(interpreted, i):
    want, got = interpreted
    assert_same(want[i], got[i], name=OUTPUTS[i])


def test_diag_fused_batch_shapes():
    cols = [to_torch(c) for c in chip_smoke.tail_columns(60, L=25, seed=2)]
    flat = tdiag.diag_fused(*cols)
    grid = tdiag.diag_fused(*(c.reshape(6, 10, -1) for c in cols))
    for a, b in zip(flat, grid):
        assert b.shape == (6, 10)
        torch.testing.assert_close(b.reshape(-1), a, equal_nan=True,
                                   rtol=0, atol=0)
    # One shared pressure column broadcast against batched fields.
    shared = tdiag.diag_fused(cols[0][0], *(c[:4] for c in cols[1:]))
    want = tdiag.diag_fused(cols[0][0].expand(4, -1), *(c[:4]
                                                        for c in cols[1:]))
    for a, b in zip(shared, want):
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)


def test_wrapper_runs_the_twin_only_for_cpu_tensors():
    cols = [to_torch(c) for c in chip_smoke.tail_columns(24, L=20)]
    before = tdiag.diag_kernel.launches
    out = tdiag.diag_kernel(*cols)
    assert out.shape == (len(OUTPUTS), 24)
    assert tdiag.diag_kernel.launches == before     # no kernel launched
    with pytest.raises(ValueError, match='no diagnostics-tail kernel'):
        tdiag.diag_kernel(*(c.to('meta') for c in cols))


# --- lifted index, SHIP and the storm proxies --------------------------------

def test_lifted_index():
    rng = np.random.default_rng(4)
    p, t, _, _ = chip_smoke.tail_columns(30, L=41, seed=4)
    profile = {'pressure': p, 'temperature': t - rng.uniform(-4, 4, t.shape),
               'environment_temperature': t}
    profile['temperature'][5, 10:] = np.nan
    want = jdiag.lifted_index({k: jnp.asarray(v) for k, v in profile.items()})
    got = tdiag.lifted_index({k: to_torch(v) for k, v in profile.items()})
    assert_same(want, got)
    assert torch.isnan(got['lifted_index']).any()


def ship_inputs(n=400, seed=6):
    """Inputs straddling every SHIP validity window and correction."""
    rng = np.random.default_rng(seed)
    x = {'mucape': rng.uniform(0, 4000, n),
         'mixing_ratio': rng.uniform(0.008, 0.016, n),
         'lapse': rng.uniform(-9.5, -4.0, n),
         'temp_500': rng.uniform(250.0, 275.0, n),
         'shear': rng.uniform(0.0, 35.0, n),
         'flh': rng.uniform(800.0, 4500.0, n)}
    for k, v in x.items():
        v[rng.integers(0, n, 5)] = np.nan
    return x


def test_significant_hail_parameter():
    x = ship_inputs()
    want = jdiag.significant_hail_parameter(
        **{k: jnp.asarray(v) for k, v in x.items()})
    got = tdiag.significant_hail_parameter(
        **{k: to_torch(v) for k, v in x.items()})
    assert_same(want, got)
    assert torch.isfinite(got).sum() > 50           # inside the windows


def proxy_inputs(n=500, seed=8):
    """conv_properties-like outputs spread across every proxy threshold."""
    rng = np.random.default_rng(seed)
    x = {'mu_cape': rng.uniform(-50, 3000, n),
         'mu_mixing_ratio': rng.uniform(0.008, 0.016, n),
         'mixed_100_cape': rng.uniform(-50, 2500, n),
         'mixed_100_cin': rng.uniform(-150, 0, n),
         'mixed_100_lifted_index': rng.uniform(-8, 6, n),
         'mixed_100_dci': rng.uniform(0, 40, n),
         'mixed_50_cape': rng.uniform(-50, 2500, n),
         'mixed_50_cin': rng.uniform(-100, 0, n),
         'lapse_rate_700_500': rng.uniform(-9, -4, n),
         'temp_500': rng.uniform(250, 275, n),
         'freezing_level': rng.uniform(800, 4500, n),
         'shear_magnitude': rng.uniform(0, 35, n),
         'positive_shear': rng.uniform(0, 1, n) > 0.3}
    for k, v in x.items():
        if v.dtype != bool:
            v[rng.integers(0, n, 8)] = np.nan
    assert set(x) == set(tpipeline.STORM_PROXY_INPUTS)
    return x


@pytest.fixture(scope='module')
def proxies():
    x = proxy_inputs()
    want = jpipeline.storm_proxies({k: jnp.asarray(v) for k, v in x.items()})
    got = tpipeline.storm_proxies({k: to_torch(v) for k, v in x.items()})
    return {k: np.asarray(v) for k, v in want.items()}, got


PROXIES = ('proxy_Craven2004', 'proxy_Kunz2007', 'proxy_Trapp2007',
           'proxy_Marsh2009', 'proxy_Allen2011', 'proxy_Allen2014',
           'proxy_Eccel2012', 'proxy_Mohr2013', 'ship', 'proxy_SHIP_0.1')


def test_storm_proxy_variable_set(proxies):
    want, got = proxies
    assert set(got) == set(want) == set(PROXIES)


@pytest.mark.parametrize('key', PROXIES)
def test_storm_proxies_match_jax(proxies, key):
    want, got = proxies
    assert_same(want[key], got[key], name=key)
    if got[key].dtype == torch.bool:
        assert 0 < int(got[key].sum()) < got[key].numel(), key
