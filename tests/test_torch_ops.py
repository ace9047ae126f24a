"""The PyTorch port's column ops and thermodynamics against the JAX package.

The same numpy inputs (from a seed, float64) go through the JAX function on
the CPU and through its port; outputs must have identical NaN patterns and
agree to ``ATOL`` (both run the same formulas in the same order, so the
only differences are the libraries' last-ulp rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import constants as jc
from xarray_parcel_tpu import lcl as jlcl
from xarray_parcel_tpu import ops as jops
from xarray_parcel_tpu import thermo as jthermo
from xarray_parcel_tpu.ops import integrate as jintegrate
from xarray_parcel_tpu_torch import constants as tc
from xarray_parcel_tpu_torch import lcl as tlcl
from xarray_parcel_tpu_torch import ops as tops
from xarray_parcel_tpu_torch import thermo as tthermo

ATOL = 1e-9


def to_torch(x):
    return torch.from_numpy(np.array(x))


def assert_same(jax_out, torch_out, atol=ATOL, rtol=1e-12, name=''):
    """Identical NaN patterns and values within ``atol``/``rtol``
    (recursing into dicts, tuples and lists)."""
    if isinstance(jax_out, dict):
        for k in torch_out:
            assert_same(jax_out[k], torch_out[k], atol, rtol, f'{name}/{k}')
        return
    if isinstance(jax_out, (tuple, list)):
        assert len(jax_out) == len(torch_out)
        for i, (a, b) in enumerate(zip(jax_out, torch_out)):
            assert_same(a, b, atol, rtol, f'{name}[{i}]')
        return
    a = np.asarray(jax_out)
    b = torch_out.numpy() if torch.is_tensor(torch_out) else np.asarray(
        torch_out)
    assert a.shape == b.shape, f'{name}: shape {a.shape} vs {b.shape}'
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=name)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                  err_msg=f'NaN pattern {name}')
    np.testing.assert_allclose(np.nan_to_num(b), np.nan_to_num(a),
                               atol=atol, rtol=rtol, err_msg=name)


def columns(B=12, L=16, seed=0):
    """Sorted pressure columns with temperature and dewpoint (float64)."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1005.0, 200.0, L) + rng.normal(0, 0.5, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 300.0 - 70.0 * (1.0 - (p / 1005.0) ** 0.3) + rng.normal(0, 2, (B, L))
    td = t - np.abs(rng.normal(3.0, 2.0, (B, L))) - 0.1
    return p, t, td


# --- constants and thermodynamics --------------------------------------------

@pytest.mark.parametrize('name', ['R', 'Md', 'Mw', 'Rd', 'Rv', 'Cp_d', 'kappa',
                                  'epsilon', 'Lv', 'sat_pressure_0c',
                                  'zero_degc', 'P0',
                                  'virtual_temperature_epsilon'])
def test_constants(name):
    assert getattr(tc, name) == getattr(jc, name)


_P, _T, _TD = columns(B=6, L=9, seed=1)
_Q = np.asarray(jthermo.specific_humidity_from_dewpoint(_P, _TD))
_W = np.asarray(jthermo.saturation_mixing_ratio(_P, _TD))
_RH = np.clip(_W / np.asarray(jthermo.saturation_mixing_ratio(_P, _T)), 0.05,
              1.0)
THERMO_CASES = {
    'saturation_vapor_pressure': (_T,),
    'dewpoint': (np.asarray(jthermo.saturation_vapor_pressure(_TD)),),
    'vapor_pressure': (_P, _W),
    'mixing_ratio_from_partial_pressure': (
        np.asarray(jthermo.saturation_vapor_pressure(_TD)), _P),
    'saturation_mixing_ratio': (_P, _T),
    'mixing_ratio': (_T, _TD, _P),
    'exner_function': (_P,),
    'potential_temperature': (_P, _T),
    'virtual_temperature': (_T, _W),
    'equivalent_potential_temperature': (_P, _T, _TD),
    'mixing_ratio_from_specific_humidity': (_Q,),
    'specific_humidity_from_mixing_ratio': (_W,),
    'specific_humidity_from_dewpoint': (_P, _TD),
    'relative_humidity_from_specific_humidity': (_P, _T, _Q),
    'dewpoint_from_relative_humidity': (_T, _RH),
    'dewpoint_from_specific_humidity': (_P, _T, _Q),
    'moist_lapse_rate': (_P, _T),
    'wet_bulb_temperature_fast': (_T, _TD),
}


@pytest.mark.parametrize('name', sorted(THERMO_CASES))
def test_thermo(name):
    args = THERMO_CASES[name]
    args = tuple(np.where(np.arange(a.size).reshape(a.shape) % 17 == 3,
                          np.nan, a) for a in args)      # a few NaN inputs
    want = getattr(jthermo, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tthermo, name)(*(to_torch(a) for a in args))
    assert_same(want, got, name=name)


def test_lcl():
    rng = np.random.default_rng(2)
    p0 = rng.uniform(500.0, 1050.0, 64)
    t0 = rng.uniform(240.0, 315.0, 64)
    td0 = t0 - rng.uniform(0.0, 30.0, 64)
    p0[3] = np.nan
    td0[9] = np.nan
    td0[11] = t0[11]                                # saturated parcel
    want = jlcl.lcl(jnp.asarray(p0), jnp.asarray(t0), jnp.asarray(td0))
    got = tlcl.lcl(to_torch(p0), to_torch(t0), to_torch(td0))
    assert set(got) == {'lcl_pressure', 'lcl_temperature',
                        'lcl_virtual_temperature'}
    assert_same(want, got, name='lcl')


# --- safe ops and reductions ------------------------------------------------

def test_safe_log_exp_and_sign_trap():
    x = np.array([[0.5, np.nan, 2.0, -1.0, 0.0, 3.0]])
    assert_same(jops.safe_log(jnp.abs(jnp.asarray(x)) + 0.1),
                tops.safe_log(to_torch(np.abs(x) + 0.1)))
    assert_same(jops.safe_exp(jnp.asarray(x)), tops.safe_exp(to_torch(x)))
    # torch.sign(nan) is 0; the crossing finder needs jnp.sign's NaN.
    assert torch.sign(torch.tensor(float('nan'))).item() == 0.0
    assert_same(jnp.sign(jnp.asarray(x)), tops.nan_sign(to_torch(x)))
    assert_same(jops.notnan(jnp.asarray(x)), tops.notnan(to_torch(x)))


@pytest.mark.parametrize('name', ['nanmax', 'nanmin', 'nansum', 'nanmean'])
def test_reductions_where_and_empty(name):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 3, (7, 9))
    x[1] = np.nan                                   # all-NaN row
    x[2, ::2] = np.nan
    where = rng.random((7, 9)) > 0.4
    where[3] = False                                # empty selection
    for w in (None, where):
        want = getattr(jops, name)(jnp.asarray(x),
                                   where=None if w is None else jnp.asarray(w))
        got = getattr(tops, name)(to_torch(x),
                                  where=None if w is None else to_torch(w))
        assert_same(want, got, name=name)
    got = getattr(tops, name)(to_torch(x), where=to_torch(where))
    assert (got[3] == 0).item() if name == 'nansum' else torch.isnan(got[3])


# --- interpolation ----------------------------------------------------------

def interp_columns():
    p, t, td = columns(B=10, L=12, seed=5)
    p[0, 4] = p[0, 3]                 # duplicate anchor coordinate
    p[1, 6] = p[1, 5]
    t[1, 6] = t[1, 5] + 3.0           # duplicate anchors, different values
    p[2, 5] = 700.0                   # exact hit at the target
    p[3, -3:] = np.nan                # NaN top padding
    t[4, 5] = np.nan                  # NaN value next to the target
    p[5] = np.linspace(1000.0, 750.0, 12)     # target above the column
    at = np.full(10, 700.0)
    at[6] = np.nan
    at[7] = p[7, 8]                   # exact hit on a per-column target
    return p, t, td, at


@pytest.mark.parametrize('log', [False, True])
def test_interp_many(log):
    p, t, td, at = interp_columns()
    want = jops.interp_many({'t': jnp.asarray(t), 'td': jnp.asarray(td)},
                            jnp.asarray(p), jnp.asarray(at), log=log)
    got = tops.interp_many({'t': to_torch(t), 'td': to_torch(td)},
                           to_torch(p), to_torch(at), log=log)
    assert_same(want, got)
    want = jops.interp_many((jnp.asarray(t),), jnp.asarray(p), 500.0,
                            log=log)
    got = tops.interp_many((to_torch(t),), to_torch(p), 500.0, log=log)
    assert isinstance(got, tuple)
    assert_same(want, got)


def test_linear_and_log_interp():
    p, t, _, at = interp_columns()
    assert_same(jops.linear_interp(jnp.asarray(t), jnp.asarray(p),
                                   jnp.asarray(at)),
                tops.linear_interp(to_torch(t), to_torch(p), to_torch(at)))
    assert_same(jops.log_interp(jnp.asarray(t), jnp.asarray(p),
                                jnp.asarray(at)),
                tops.log_interp(to_torch(t), to_torch(p), to_torch(at)))


# --- intersections and integration ----------------------------------------

def crossing_tracks():
    """Parcel/environment tracks with crossings, exact touches (sign 0),
    NaN gaps next to touches and duplicate coordinates."""
    p, t, _ = columns(B=10, L=14, seed=6)
    rng = np.random.default_rng(7)
    a = t + rng.normal(0, 1.5, t.shape)
    b = t.copy()
    a[0, 3] = b[0, 3]                 # exact touch
    a[1, 4] = b[1, 4]
    a[1, 5] = np.nan                  # NaN gap right after a touch
    b[2, 7] = np.nan                  # NaN environment level
    p[3, 8] = p[3, 7]                 # duplicate coordinate
    p[4, -2:] = np.nan                # NaN-pressure padding
    a[5, 0] = b[5, 0]                 # touch at the first level
    return p, a, b


@pytest.mark.parametrize('log_x,log_outputs', [(False, False), (True, False),
                                               (True, True)])
def test_find_intersections(log_x, log_outputs):
    p, a, b = crossing_tracks()
    kw = dict(log_x=log_x, log_outputs=log_outputs)
    lp = np.log(p) if log_x else None
    want = jops.find_intersections(jnp.asarray(p), jnp.asarray(a),
                                   jnp.asarray(b), log_x_values=(
                                       None if lp is None else
                                       jnp.asarray(lp)), **kw)
    got = tops.find_intersections(to_torch(p), to_torch(a), to_torch(b),
                                  log_x_values=(None if lp is None else
                                                to_torch(lp)), **kw)
    assert set(got) == set(want)
    assert_same(want, got)


def test_gap_and_select_areas():
    p, a, b = crossing_tracks()
    y, x = a - b, np.log(p)
    want_a, want_v = jintegrate.gap_areas(jnp.asarray(y), jnp.asarray(x))
    got_a, got_v = tops.gap_areas(to_torch(y), to_torch(x))
    assert_same(want_v, got_v)
    assert_same(jnp.where(want_v, want_a, 0.0), torch.where(got_v, got_a, 0.0))
    mask = np.random.default_rng(8).random(want_v.shape) > 0.3
    for pos, neg in ((False, False), (True, False), (False, True)):
        assert_same(
            jintegrate.select_areas(want_a, want_v, jnp.asarray(mask),
                                    only_positive=pos, only_negative=neg),
            tops.select_areas(got_a, got_v, to_torch(mask),
                              only_positive=pos, only_negative=neg))
    with pytest.raises(ValueError):
        tops.select_areas(got_a, got_v, only_positive=True,
                          only_negative=True)


def test_trap_around_zeros():
    p, a, b = crossing_tracks()
    lp = np.log(p)
    want_ints = jops.find_intersections(
        jnp.asarray(p), jnp.asarray(a), jnp.asarray(b), log_x=True,
        log_x_values=jnp.asarray(lp), log_outputs=True)
    got_ints = tops.find_intersections(
        to_torch(p), to_torch(a), to_torch(b), log_x=True,
        log_x_values=to_torch(lp), log_outputs=True)
    want, want_mask = jops.trap_around_zeros(
        jnp.asarray(p), jnp.asarray(a - b), log_x=True,
        intersections=want_ints, log_x_values=jnp.asarray(lp))
    got, got_mask = tops.trap_around_zeros(
        to_torch(p), to_torch(a - b), log_x=True, intersections=got_ints,
        log_x_values=to_torch(lp))
    assert set(got) == set(want) == {'area', 'x', 'dx', 'x_from', 'x_to'}
    assert_same(want, got)
    assert_same(want_mask, got_mask)
    # Self-built crossing set (the zero line).
    want, _ = jops.trap_around_zeros(jnp.asarray(p), jnp.asarray(a - b))
    got, _ = tops.trap_around_zeros(to_torch(p), to_torch(a - b))
    assert_same(want, got)


# --- levels -------------------------------------------------------------------

def splice_case():
    p, t, td = columns(B=9, L=10, seed=9)
    lcl_p = p[:, 3] - 7.0
    lcl_p[0] = p[0, 2]                # duplicate of an existing level
    lcl_p[1] = np.nan                 # NaN insertion coordinate: flood
    lcl_p[2] = p[2, 0] + 5.0          # below the surface
    lcl_p[3] = p[3, -1] - 5.0         # above the top
    p[4, 5] = np.nan                  # interior NaN-pressure slot
    p[5, -3:] = np.nan                # NaN top padding
    lead = np.zeros(9, np.int64)
    p[6, :3] = t[6, :3] = td[6, :3] = np.nan     # masked sub-parcel prefix
    lead[6] = 3
    p[7, :2] = np.nan
    lead[7] = 2
    lcl_p[7] = p[7, 5] + 500.0        # LCL "below" the prefix: kept above it
    fields = {'pressure': p, 'temperature': t, 'dewpoint': td}
    level = {'pressure': lcl_p, 'temperature': np.full(9, 280.0),
             'dewpoint': np.full(9, 275.0)}
    return fields, level, lead


@pytest.mark.parametrize('with_lead', [False, True])
def test_insert_level(with_lead):
    fields, level, lead = splice_case()
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    jl = {k: jnp.asarray(v) for k, v in level.items()}
    tf = {k: to_torch(v) for k, v in fields.items()}
    tl = {k: to_torch(v) for k, v in level.items()}
    want = jops.insert_level(jf, jl, lead=jnp.asarray(lead) if with_lead
                             else None)
    got = tops.insert_level(tf, tl, lead=to_torch(lead) if with_lead
                            else None)
    assert got['pressure'].shape == (9, 11)
    assert_same(want, got)
    # The duplicate goes above the existing level; the flood fills all.
    assert got['pressure'][0, 3] == got['pressure'][0, 2]
    assert torch.isnan(got['pressure'][1]).all()
    assert (got['temperature'][1] == 280.0).all()


def test_first_valid_index():
    fields, _, _ = splice_case()
    p = fields['pressure']
    p[8] = np.nan                     # all-NaN column: index 0
    want = jnp.argmax(jops.notnan(jnp.asarray(p)), axis=-1)
    got = tops.first_valid_index(to_torch(p))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(RuntimeError):
        torch.argmax(torch.ones(3, dtype=torch.bool))   # why the cast


def test_bound_pressure_and_get_layer():
    p, t, td = columns(B=8, L=12, seed=10)
    p[0, 3] = np.nan
    p[1, -2:] = np.nan
    bound = p[:, 0] - np.array([100.0, 250.0, 50.0, 300.0, 10.0, 0.0,
                                900.0, 150.0])
    assert_same(jops.bound_pressure(jnp.asarray(p), jnp.asarray(bound)),
                tops.bound_pressure(to_torch(p), to_torch(bound)))
    for depth in (50.0, 100.0, 250.0):
        want = jops.get_layer({'pressure': jnp.asarray(p),
                               'temperature': jnp.asarray(t)},
                              depth=depth, interpolate=False)
        got = tops.get_layer({'pressure': to_torch(p),
                              'temperature': to_torch(t)}, depth=depth,
                             interpolate=False)
        assert_same(want, got)
