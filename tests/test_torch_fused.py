"""The port's fused CAPE/CIN solve against the JAX package's Pallas kernel.

The JAX side runs its kernel in Pallas interpret mode on the CPU, as
``tests/test_fused.py`` does; the port runs its plain twin (CPU tensors never
reach the CUDA kernel).  All seven outputs must have identical NaN patterns
and agree to atol 1e-6, the bound ``test_fused.py`` uses; the profile tracks
(``with_profile``) to ``assert_same``'s 1e-9.  The solve's four options
(six settings) are held to JAX's fused solve at the same atol 1e-6, and to
the port's own modular ``cape.cape_cin`` (fused equals modular, as
``tests/test_fused_pipeline.py`` pins for the JAX package) at 1e-6 of each
output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import fused as jfused
from xarray_parcel_tpu import parcels as jparcels
from xarray_parcel_tpu_torch import AdiabatTables
from xarray_parcel_tpu_torch import cape as tcape
from xarray_parcel_tpu_torch import diagnostics as tdiag
from xarray_parcel_tpu_torch import fused as tfused

import chip_smoke
from test_torch_ops import assert_same, to_torch

ATOL = 1e-6
KEYS = ('cape', 'cin', 'lifted_index', 'lfc_pressure', 'lfc_temperature',
        'el_pressure', 'el_temperature')


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


def grid(B=64, L=40, seed=3):
    """``test_fused._grid``-style convective soundings plus the hard cases:
    poisoned columns, NaN pressure padding, duplicate levels, a parcel too
    hot for the adiabat family and an all-NaN column."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1010.0, 150.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.4, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 302.0 - 76.0 * (1.0 - (p / 1010.0) ** 0.3) + rng.normal(0, 2, (B, L))
    td = (t - np.abs(rng.normal(2.0, 2.0, (B, L))) - 0.2
          - 15.0 * (1.0 - p / 1010.0) ** 2)
    t[3] = np.nan
    td[7, 0] = np.nan
    p[9, -6:] = np.nan
    t[11, 20] = np.nan
    p[13, 11] = p[13, 10]
    p[15, 1] = p[15, 0]
    t[17, 0] += 45.0
    p[19] = np.nan
    return p, t, td


def split(res, sol):
    return {**res, **sol}


def run_both(jax_tables, tables, p, t, td, parcel=None, **kw):
    jp = {} if parcel is None else {
        f'parcel_{k}': jnp.asarray(v) for k, v in parcel.items()}
    tp = {} if parcel is None else {
        f'parcel_{k}': to_torch(v) for k, v in parcel.items()}
    kw.setdefault('with_lifted_index', True)
    want = split(*jfused.fused_cape_cin(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(td), tables=jax_tables,
        **jp, **kw))
    got = split(*tfused.fused_cape_cin(
        to_torch(p), to_torch(t), to_torch(td), tables=tables, **tp, **kw))
    return want, got


def prepped(kind, p, t, td):
    """Masked columns and parcel state from the JAX package's preps."""
    args = (jnp.asarray(p), jnp.asarray(t), jnp.asarray(td))
    if kind == 'most_unstable':
        fields, parcel = jparcels.from_most_unstable_parcel(*args,
                                                            depth=250.0)
    else:
        fields, parcel = jparcels.mix_layer(*args, depth=float(kind[6:]),
                                            grow=False)
    fields = [np.asarray(fields[k]) for k in ('pressure', 'temperature',
                                              'dewpoint')]
    return fields, {k: np.asarray(v) for k, v in parcel.items()}


@pytest.fixture(scope='module')
def surface(jax_tables, tables):
    return run_both(jax_tables, tables, *grid())


@pytest.mark.parametrize('key', KEYS)
def test_surface_matches_jax(surface, key):
    want, got = surface
    assert got[key].shape == (64,) and got[key].dtype == torch.float64
    assert_same(want[key], got[key], atol=ATOL, rtol=0, name=key)


@pytest.mark.parametrize('L', [33, 137])
def test_surface_matches_jax_at_lane_edges(jax_tables, tables, L):
    """Widths around the wrap of the warp that strides over a column on the
    card, 32 levels at a time, on columns whose LCL slot, duplicated
    levels, NaN gaps and tied LFC/EL candidates straddle levels 31/32 and
    63/64 (``chip_smoke.lane_edge_columns``): the plain twin that judges
    the CUDA kernel there is itself held to JAX."""
    want, got = run_both(jax_tables, tables,
                         *chip_smoke.lane_edge_columns(24, L=L, seed=L))
    for key in KEYS:
        assert_same(want[key], got[key], atol=ATOL, rtol=0, name=key)
    assert torch.isfinite(got['lfc_pressure']).sum() > 5


def test_surface_cases_are_exercised(surface):
    _, got = surface
    assert torch.isnan(got['cape'][19]) == torch.isnan(got['cape'][3])
    assert (got['cape'] > 1.0).sum() > 10               # convective columns
    assert torch.isnan(got['lfc_pressure']).any()


@pytest.mark.parametrize('kind', ['most_unstable', 'mixed_100', 'mixed_50'])
def test_masked_prefix_parcels_match_jax(jax_tables, tables, kind):
    p, t, td = grid(B=48, seed=5)
    fields, parcel = prepped(kind, p, t, td)
    assert np.isnan(fields[0][:, 0]).sum() > 10      # NaN-prefixed columns
    want, got = run_both(jax_tables, tables, *fields, parcel=parcel)
    for key in KEYS:
        assert_same(want[key], got[key], atol=ATOL, rtol=0, name=key)


@pytest.fixture(scope='module')
def profiles(jax_tables, tables):
    """Both solves with their profile tracks, for the surface parcel and
    the most-unstable one (NaN-prefixed columns)."""
    p, t, td = grid(B=40, seed=9)
    out = {'surface': run_both(jax_tables, tables, p, t, td,
                               with_lifted_index=False, with_profile=True)}
    fields, parcel = prepped('most_unstable', p, t, td)
    out['most_unstable'] = run_both(jax_tables, tables, *fields,
                                    parcel=parcel, with_lifted_index=False,
                                    with_profile=True)
    return out


@pytest.mark.parametrize('kind', ['surface', 'most_unstable'])
@pytest.mark.parametrize('track', tfused.PROFILE)
def test_profile_tracks_match_jax(profiles, kind, track):
    want, got = profiles[kind]
    assert 'lifted_index' not in got
    assert got['profile'][track].shape == (40, 41)
    assert_same(want['profile'][track], got['profile'][track],
                name=f'{kind}/{track}')


def test_profile_run_keeps_the_solve(profiles, jax_tables, tables):
    """With the profile tracks on, the scalar outputs are the solve's own,
    and the LI interpolated from the tracks is the in-kernel LI."""
    _, got = profiles['surface']
    p, t, td = grid(B=40, seed=9)
    _, plain = run_both(jax_tables, tables, p, t, td)
    for key in KEYS[:2] + KEYS[3:]:
        torch.testing.assert_close(got[key], plain[key], equal_nan=True,
                                   rtol=0, atol=0)
    li = tdiag.lifted_index(got['profile'])['lifted_index']
    assert_same(plain['lifted_index'].numpy(), li)
    prof = got['profile']['pressure']
    assert torch.isnan(prof[19]).all()                  # all-NaN column


def test_golden_sounding(jax_tables, tables):
    # The reference's golden surface-parcel sounding: cape 230.20,
    # cin -58.07 (tests/test_fused.py::test_fused_golden).
    p = np.array([[959., 779.2, 751.3, 724.3, 700., 269.]])
    t = np.array([[22.2, 14.6, 12., 9.4, 7., -38.]]) + 273.15
    td = np.array([[19., -11.2, -10.8, -10.4, -10., -53.2]]) + 273.15
    want, got = run_both(jax_tables, tables, p, t, td)
    for key in KEYS:
        assert_same(want[key], got[key], atol=ATOL, rtol=0, name=key)
    assert abs(got['cape'].item() - 230.20) < 0.5
    assert abs(got['cin'].item() - (-58.07)) < 0.5


def test_batch_shape_round_trip(tables):
    p, t, td = (to_torch(x) for x in grid(B=70, seed=4))
    flat, _ = tfused.fused_surface_cape_cin(p, t, td, tables=tables)
    res, sol = tfused.fused_surface_cape_cin(
        p.reshape(7, 10, -1), t.reshape(7, 10, -1), td.reshape(7, 10, -1),
        tables=tables)
    assert res['cape'].shape == sol['el_pressure'].shape == (7, 10)
    assert 'lifted_index' not in res
    torch.testing.assert_close(res['cape'].reshape(-1), flat['cape'],
                               equal_nan=True, rtol=0, atol=0)
    # One shared environment column with batched parcels.
    res, _ = tfused.fused_cape_cin(p[0], t[0], td[0],
                                   parcel_pressure=p[:5, 0],
                                   parcel_temperature=t[:5, 0],
                                   parcel_dewpoint=td[:5, 0], tables=tables)
    assert res['cape'].shape == (5,)
    torch.testing.assert_close(res['cape'][0], flat['cape'][0])


def test_wrapper_runs_the_twin_only_for_cpu_tensors(tables):
    p, t, td = (to_torch(x) for x in grid(B=24, seed=6))
    row, scalars, k0 = tfused.prepass(p, p[:, 0], t[:, 0], td[:, 0], tables)
    assert k0.dtype == torch.int32 and scalars.shape == (24, 6)
    assert row.shape == (24, 42)
    before = tfused.cape_cin_kernel.launches
    out = tfused.cape_cin_kernel(p, t, td, row, scalars, k0)
    assert out.shape == (len(tfused.OUTPUTS), 24)
    out, prof = tfused.cape_cin_kernel(p, t, td, row, scalars, k0,
                                       with_profile=True)
    assert prof.shape == (len(tfused.PROFILE), 24, p.shape[1] + 1)
    assert tfused.cape_cin_kernel.launches == before   # no kernel launched
    meta = [x.to('meta') for x in (p, t, td, row, scalars, k0)]
    with pytest.raises(ValueError, match='no CAPE/CIN kernel'):
        tfused.cape_cin_kernel(*meta)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_prepass_function_returns_the_twin(tables, dtype):
    """On CPU tensors the pre-pass's wrapper, with and without the
    seam's autograd.Function, returns the plain twin's values exactly, and
    launches nothing."""
    tab = tables.astype(dtype)
    args = chip_smoke.prepass_args(60, L=24, dtype=dtype)
    want = tfused._prepass_twin(*args, tab)
    before = tfused.prepass_kernel.launches
    leaves = [x.clone().requires_grad_() for x in args[1:]]
    for got in (tfused.prepass_kernel(*args, tab),
                tfused.prepass(*args, tab),
                tfused.prepass_kernel(args[0], *leaves, tab)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a.detach(), b, equal_nan=True,
                                       rtol=0, atol=0)
    assert tfused.prepass_kernel.launches == before
    k0 = want[2]
    assert (k0 > 0).any() and torch.isnan(want[0]).all(-1).any()
    assert torch.isnan(want[1][:, 0]).any()
    with pytest.raises(ValueError, match='no pre-pass kernel'):
        tfused.prepass_kernel(*(x.to('meta') for x in args), tab)


def test_float32_twin_within_budget(jax_tables):
    """The float32 plain twin against the float64 JAX solve: the fp32
    budget of docs/performance.md (p95 <= 1e-4, max <= 5e-4 of each
    output's scale, NaN flips <= 1%)."""
    p, t, td = grid(B=64, seed=8)
    want = split(*jfused.fused_surface_cape_cin(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(td), tables=jax_tables,
        with_lifted_index=True))
    tab32 = AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                     torch.float32)
    got = split(*tfused.fused_surface_cape_cin(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (p, t, td)),
        tables=tab32, with_lifted_index=True))
    for key in KEYS:
        a = np.asarray(want[key])
        b = got[key].double().numpy()
        assert np.mean(np.isnan(a) != np.isnan(b)) <= 0.01, key
        both = ~np.isnan(a) & ~np.isnan(b)
        scale = max(1.0, float(np.nanmax(np.abs(a))))
        d = np.abs(a[both] - b[both]) / scale
        assert np.quantile(d, 0.95) <= 1e-4 and d.max() <= 5e-4, key


# --- the solve's options -----------------------------------------------------

SOLVE_KW = [dict(), dict(virtual_temperature_correction=False),
            dict(lcl_interp='linear'), dict(pos_cape_neg_cin=False),
            dict(post_zero_cin=True),
            dict(virtual_temperature_correction=False, lcl_interp='linear',
                 pos_cape_neg_cin=False, post_zero_cin=True)]


def kw_id(kw):
    return '-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'


@pytest.mark.parametrize('kw', SOLVE_KW, ids=kw_id)
def test_options_match_jax(jax_tables, tables, kw):
    """Each option alone and all four together, on the hard grid and on
    the lane-edge columns: all seven outputs to atol 1e-6."""
    for cols in (grid(B=48, seed=12),
                 chip_smoke.lane_edge_columns(24, L=33, seed=33)):
        want, got = run_both(jax_tables, tables, *cols, **kw)
        for key in KEYS:
            assert_same(want[key], got[key], atol=ATOL, rtol=0,
                        name=f'{kw_id(kw)}/{key}')
        assert (got['cape'].abs() > 1.0).sum() > 5


@pytest.mark.parametrize('kw', SOLVE_KW, ids=kw_id)
def test_options_profile_tracks_match_jax(jax_tables, tables, kw):
    """The profile tracks are real temperatures under every option."""
    p, t, td = grid(B=32, seed=13)
    want, got = run_both(jax_tables, tables, p, t, td,
                         with_lifted_index=False, with_profile=True, **kw)
    for track in tfused.PROFILE:
        assert_same(want['profile'][track], got['profile'][track],
                    name=f'{kw_id(kw)}/{track}')


@pytest.mark.parametrize('kw', SOLVE_KW, ids=kw_id)
def test_options_fused_equals_modular(tables, kw):
    """The port's fused solve against its own modular ``cape_cin`` with the
    same options, on the JAX package's tables: same NaN pattern, 1e-6 of
    each output's scale (both evaluate the same blended spectral row)."""
    p, t, td = grid(B=48, seed=14)
    args = [to_torch(x) for x in (p, t, td)]
    res, sol = tfused.fused_surface_cape_cin(*args, tables=tables, **kw)
    want_res, want_sol = tcape.surface_based_cape_cin(*args, tables=tables,
                                                      **kw)
    for key in KEYS:
        if key == 'lifted_index':
            continue
        got = {**res, **sol}[key]
        want = {**want_res, **want_sol}[key]
        scale = max(1.0, float(np.nanmax(np.abs(want.numpy()))))
        assert_same(want.numpy(), got, atol=1e-6 * scale, rtol=0,
                    name=f'{kw_id(kw)}/{key}')


def test_options_are_validated(tables):
    p, t, td = (to_torch(x) for x in grid(B=24, seed=15))
    with pytest.raises(TypeError):
        tfused.fused_cape_cin(p, t, td, tables=tables, no_such_option=1)
    with pytest.raises(ValueError, match='lcl_interp'):
        tfused.fused_cape_cin(p, t, td, tables=tables, lcl_interp='cubic')
    assert tfused.option_flags({}) == 0
    assert [tfused.option_flags(kw) for kw in SOLVE_KW] == [0, 1, 2, 4, 8, 15]
    row, scalars, k0 = tfused.prepass(p, p[:, 0], t[:, 0], td[:, 0], tables)
    with pytest.raises(TypeError):
        tfused.cape_cin_kernel(p, t, td, row, scalars, k0, vtc=False)


@pytest.mark.parametrize('kw', SOLVE_KW[1:], ids=kw_id)
def test_options_reach_the_gradient(tables, kw):
    """The solve's Function carries the options into its backward: the CAPE
    gradient equals the plain twin's under the same options."""
    p, t, td = (to_torch(x) for x in grid(B=24, seed=16))
    t1 = t.clone().requires_grad_(True)
    res, _ = tfused.fused_cape_cin(p, t1, td, tables=tables, **kw)
    res['cape'].nansum().backward()
    t2 = t.clone().requires_grad_(True)
    row, scalars, k0 = tfused.prepass(p, p[:, 0], t2[:, 0], td[:, 0], tables)
    out = tfused._column_outputs(p, t2, td, row, scalars, k0, **kw)
    out[0].nansum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, equal_nan=True)
    assert (t1.grad.nan_to_num() != 0).any()
