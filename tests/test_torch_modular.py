"""The port's modular path against the JAX package.

The same numpy inputs (from a seed, float64) go through the JAX function on
the CPU and its port: the thermodynamics and ops added with the modular
path, ``moist_lapse`` in every mode (with the JAX package's own tables
carried across by ``AdiabatTables.from_numpy``) and its RK4 oracle, the
parcel profiles, ``cape_cin`` and its parcel variants, the exact wet bulb,
and the modular pipelines.  Columns carry NaN-poisoned levels and columns,
leading-NaN prefixes and duplicate levels.  Tolerances: identical NaN
patterns, and 1e-9 absolute (``assert_same``) for ops, profiles,
``moist_lapse`` and the parcel solves; 1e-6 of each output's scale for the
pipelines.  The port's modular pipelines also meet the regression archive
at the archive test's tolerance, and its fused pipelines match its modular
ones, as ``tests/test_fused_pipeline.py`` holds the JAX package's.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu import diagnostics as jdiag
from xarray_parcel_tpu import ops as jops
from xarray_parcel_tpu import parcels as jparcels
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu import profile as jprofile
from xarray_parcel_tpu import thermo as jthermo
from xarray_parcel_tpu_torch import AdiabatTables
from xarray_parcel_tpu_torch import adiabat as tad
from xarray_parcel_tpu_torch import cape as tcape
from xarray_parcel_tpu_torch import diagnostics as tdiag
from xarray_parcel_tpu_torch import ops as tops
from xarray_parcel_tpu_torch import parcels as tparcels
from xarray_parcel_tpu_torch import pipeline as tpipeline
from xarray_parcel_tpu_torch import profile as tprofile
from xarray_parcel_tpu_torch import thermo as tthermo

from make_regression_archive import ARCHIVE, make_inputs
from test_torch_ops import assert_same, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

OUTPUTS = sorted([
    'mu_cape', 'mu_cin', 'mu_mixing_ratio', 'mixed_100_cape',
    'mixed_100_cin', 'mixed_50_cape', 'mixed_50_cin', 'mu_lifted_index',
    'mixed_100_lifted_index', 'mixed_50_lifted_index', 'mu_dci',
    'mixed_100_dci', 'mixed_50_dci', 'lapse_rate_700_500', 'temp_500',
    'freezing_level', 'melting_level', 'shear_u', 'shear_v',
    'shear_magnitude', 'positive_shear'])
MIN_OUTPUTS = sorted([
    'mixed_100_cape', 'mixed_100_cin', 'mixed_100_lifted_index',
    'lapse_rate_700_500', 'temp_500', 'freezing_level', 'melting_level',
    'shear_u', 'shear_v', 'shear_magnitude', 'positive_shear'])
PROXIES = sorted([
    'proxy_Craven2004', 'proxy_Kunz2007', 'proxy_Trapp2007',
    'proxy_Marsh2009', 'proxy_Allen2011', 'proxy_Allen2014',
    'proxy_Eccel2012', 'proxy_Mohr2013', 'ship', 'proxy_SHIP_0.1'])


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    """The JAX package's coefficients, curves and lookup table."""
    return AdiabatTables.from_numpy(
        np.asarray(jax_tables.coeffs), 'cpu', torch.float64,
        curves=np.asarray(jax_tables.curves),
        lookup=np.asarray(jax_tables.lookup))


def hard(n=40, L=24, seed=3):
    """``chip_smoke.hard_columns`` (poisoned columns and levels, NaN
    padding, duplicate levels, too-hot parcels, all-NaN columns) plus
    leading-NaN prefixes on two columns."""
    p, t, td = chip_smoke.hard_columns(n, L=L, seed=seed)
    p[[1, 2], :3] = np.nan
    return p, t, td


def first_valid_state(p, t, td):
    """Each column's state at its first valid pressure."""
    k = np.argmax(~np.isnan(p), axis=-1)
    return tuple(np.take_along_axis(x, k[:, None], -1)[:, 0]
                 for x in (p, t, td))


def both(jfn, tfn, *args, **kw):
    """``jfn`` on the arrays as JAX arrays, ``tfn`` on them as tensors."""
    return (jfn(*(jnp.asarray(a) for a in args), **kw),
            tfn(*(to_torch(a) for a in args), **kw))


# --- thermodynamics and ops --------------------------------------------------

@pytest.mark.parametrize('name', ['dry_lapse',
                                  'relative_humidity_from_dewpoint',
                                  'mixing_ratio_from_relative_humidity'])
def test_thermo(name):
    p, t, td = hard()
    args = {'dry_lapse': (p, t, p[:, :1]),
            'relative_humidity_from_dewpoint': (t, td),
            'mixing_ratio_from_relative_humidity': (p, t, td / t)}[name]
    assert_same(*both(getattr(jthermo, name), getattr(tthermo, name),
                      *args))


@pytest.mark.parametrize('fn', ['linear_interp', 'log_interp'])
@pytest.mark.parametrize('extrapolate', [False, True])
def test_interp_extrapolate(fn, extrapolate):
    p, t, _ = hard()
    p[5, 2] = p[5, 1] = p[5, 0]                 # duplicate bottom levels
    rng = np.random.default_rng(2)
    # Targets inside, below and above the columns, and exactly at a level.
    at = rng.uniform(100.0, 1100.0, p.shape[0])
    at[6] = p[6, 4]
    assert_same(*both(getattr(jops, fn), getattr(tops, fn), t, p, at,
                      extrapolate=extrapolate))
    jw = jops.interp_many({'t': jnp.asarray(t), 'p2': jnp.asarray(2 * p)},
                          jnp.asarray(p), 1050.0, extrapolate=extrapolate,
                          log=True)
    tw = tops.interp_many({'t': to_torch(t), 'p2': to_torch(2 * p)},
                          to_torch(p), 1050.0, extrapolate=extrapolate,
                          log=True)
    assert_same(jw, tw)


def test_trapz():
    p, t, td = hard()
    y = t - td - 3.0
    mask = np.random.default_rng(4).uniform(size=(p.shape[0],
                                                  p.shape[1] - 1)) > 0.3
    for kw in ({}, {'mask': mask}, {'only_positive': True},
               {'only_negative': True, 'mask': mask}):
        jkw = {k: jnp.asarray(v) if k == 'mask' else v
               for k, v in kw.items()}
        tkw = {k: to_torch(v) if k == 'mask' else v for k, v in kw.items()}
        assert_same(jops.trapz(jnp.asarray(y), jnp.asarray(np.log(p)),
                               **jkw),
                    tops.trapz(to_torch(y), to_torch(np.log(p)), **tkw))


@pytest.mark.parametrize('interpolate', [False, True])
def test_get_layer(interpolate):
    p, t, td = hard()
    fields = {'pressure': p, 'temperature': t, 'dewpoint': td}
    for depth in (50.0, 300.0):
        want = jops.get_layer({k: jnp.asarray(v) for k, v in fields.items()},
                              depth=depth, interpolate=interpolate)
        got = tops.get_layer({k: to_torch(v) for k, v in fields.items()},
                             depth=depth, interpolate=interpolate)
        assert got['pressure'].shape[-1] == p.shape[-1] + interpolate
        assert_same(want, got)


# --- moist adiabat -----------------------------------------------------------

MODES = [dict(), dict(index_mode='bilinear'), dict(index_mode='nearest'),
         dict(curve_blend=False), dict(bilinear=False),
         dict(index_mode='bilinear', curve_blend=False)]


def lift_state(n=40, L=24, seed=3):
    """Levels and LCL-like parcel states, some outside the tables."""
    p, t, td = hard(n, L, seed)
    rng = np.random.default_rng(seed)
    pp = rng.uniform(500.0, 1000.0, n)
    pt = rng.uniform(230.0, 305.0, n)
    pp[3], pt[4] = np.nan, np.nan
    pt[5] = 340.0                                # outside the curve family
    p[7, 5] = 3000.0                             # outside the grid
    return p, pt, pp


@pytest.mark.parametrize('mode', MODES, ids=lambda m: '-'.join(
    f'{k}={v}' for k, v in m.items()) or 'default')
def test_moist_lapse_profile_modes(jax_tables, tables, mode):
    p, pt, pp = lift_state()
    want = jad.moist_lapse(jnp.asarray(p), jnp.asarray(pt), jnp.asarray(pp),
                           tables=jax_tables, pointwise=False, **mode)
    got = tad.moist_lapse(to_torch(p), to_torch(pt), to_torch(pp),
                          tables=tables, pointwise=False, **mode)
    assert_same(want, got)
    assert torch.isfinite(got).sum() > got.numel() // 2


@pytest.mark.parametrize('mode', MODES[:4], ids=lambda m: '-'.join(
    f'{k}={v}' for k, v in m.items()) or 'default')
def test_moist_lapse_pointwise_modes(jax_tables, tables, mode):
    p, pt, pp = lift_state()
    pt = pt[:, None] + 0.0 * p
    pp = np.minimum(pp[:, None], p)
    want = jad.moist_lapse(jnp.asarray(p), jnp.asarray(pt), jnp.asarray(pp),
                           tables=jax_tables, pointwise=True, **mode)
    got = tad.moist_lapse(to_torch(p), to_torch(pt), to_torch(pp),
                          tables=tables, pointwise=True, **mode)
    assert_same(want, got)


def test_moist_lapse_shapes_and_defaults(jax_tables, tables):
    """A shared level vector with batched parcels, Python scalars, the
    default parcel pressure and the shape-decided pointwise mode."""
    lv = np.array([1000., 900., 800., 600., 400., 250.])
    pt = np.array([293.0, 285.0, 301.0])
    want = jad.moist_lapse(jnp.asarray(lv), jnp.asarray(pt), 1000.0,
                           tables=jax_tables)
    got = tad.moist_lapse(to_torch(lv), to_torch(pt), 1000.0, tables=tables)
    assert got.shape == (3, 6)
    assert_same(want, got)
    assert_same(jad.moist_lapse(jnp.asarray(lv), 293.0, tables=jax_tables),
                tad.moist_lapse(to_torch(lv), 293.0, tables=tables))
    pw = lv[:3]
    assert_same(jad.moist_lapse(jnp.asarray(pw), jnp.asarray(pt),
                                tables=jax_tables, curve_blend=False),
                tad.moist_lapse(to_torch(pw), to_torch(pt), tables=tables,
                                curve_blend=False))


def test_table_modes_need_their_buffers(tables):
    bare = AdiabatTables(tables.coeffs)
    p, pt, pp = (to_torch(x) for x in lift_state(8, 6))
    tad.moist_lapse(p, pt, pp, tables=bare)          # default: coeffs only
    with pytest.raises(ValueError, match='tables.lookup'):
        tad.moist_lapse(p, pt, pp, tables=bare, index_mode='nearest')
    with pytest.raises(ValueError, match='tables.curves'):
        tad.moist_lapse(p, pt, pp, tables=bare, curve_blend=False)
    with pytest.raises(ValueError, match='index_mode'):
        tad.moist_lapse(p, pt, pp, tables=tables, index_mode='cubic')
    with pytest.raises(ValueError):
        AdiabatTables(tables.coeffs, curves=tables.curves[:, :10])
    moved = copy.deepcopy(tables).to(torch.float32)       # in place
    assert moved.curves.dtype == moved.coeffs.dtype == torch.float32
    assert tables.coeffs.dtype == torch.float64


@pytest.mark.parametrize('pointwise', [False, True])
def test_moist_lapse_integrate(pointwise):
    p, pt, pp = lift_state(16, 10)
    if pointwise:
        pt = pt[:, None] + 0.0 * p
        pp = np.minimum(pp[:, None], p)
    assert_same(*both(jad.moist_lapse_integrate, tad.moist_lapse_integrate,
                      p, pt, pp, n_substeps=8, pointwise=pointwise))
    lv = np.array([1050., 800., np.nan, 500., 400.])
    assert_same(jad.moist_lapse_integrate(jnp.asarray(lv), 293.0, 1000.0),
                tad.moist_lapse_integrate(to_torch(lv), 293.0, 1000.0))


# --- profiles ----------------------------------------------------------------

BACKENDS = {'tables': (None, None),
            'integrate': (jad.moist_lapse_integrate,
                          tad.moist_lapse_integrate)}


@pytest.mark.parametrize('backend', BACKENDS)
def test_parcel_profile(jax_tables, tables, backend):
    p, t, td = hard()
    jml, tml = BACKENDS[backend]
    state = first_valid_state(p, t, td)
    want = jprofile.parcel_profile(*(jnp.asarray(x) for x in (p, *state)),
                                   tables=jax_tables, moist_lapse=jml)
    got = tprofile.parcel_profile(*(to_torch(x) for x in (p, *state)),
                                  tables=tables, moist_lapse=tml)
    assert_same(want, got)
    env = {'pressure': want['pressure'], 'temperature': jnp.asarray(t)}
    for interpolator in ('log', 'linear'):
        assert_same(jprofile.add_lcl_to_profile(want, env, interpolator),
                    tprofile.add_lcl_to_profile(
                        got, {k: to_torch(np.asarray(v))
                              for k, v in env.items()}, interpolator))


@pytest.mark.parametrize('lcl_interp', ['log', 'linear'])
def test_parcel_profile_with_lcl(jax_tables, tables, lcl_interp):
    p, t, td = hard()
    state = first_valid_state(p, t, td)
    want = jprofile.parcel_profile_with_lcl(
        *(jnp.asarray(x) for x in (p, t, td, *state)),
        lcl_interp=lcl_interp, tables=jax_tables)
    got = tprofile.parcel_profile_with_lcl(
        *(to_torch(x) for x in (p, t, td, *state)), lcl_interp=lcl_interp,
        tables=tables)
    assert got['environment_dewpoint'].shape == (40, 25)
    assert_same(want, got)
    with pytest.raises(ValueError):
        tprofile.add_lcl_to_profile(got, interpolator='cubic')


# --- parcel solves -----------------------------------------------------------

SOLVE_KW = [dict(), dict(virtual_temperature_correction=False),
            dict(lcl_interp='linear'), dict(pos_cape_neg_cin=False),
            dict(post_zero_cin=True),
            dict(virtual_temperature_correction=False, lcl_interp='linear',
                 pos_cape_neg_cin=False, post_zero_cin=True)]


def kw_id(kw):
    return '-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'


@pytest.mark.parametrize('kw', SOLVE_KW, ids=kw_id)
def test_cape_cin(jax_tables, tables, kw):
    """``cape_cin`` from each column's first valid level (the leading-NaN
    columns included) and ``surface_based_cape_cin``."""
    p, t, td = hard()
    state = first_valid_state(p, t, td)
    want = jcape.cape_cin(*(jnp.asarray(x) for x in (p, t, td)),
                          parcel_pressure=jnp.asarray(state[0]),
                          parcel_temperature=jnp.asarray(state[1]),
                          parcel_dewpoint=jnp.asarray(state[2]),
                          tables=jax_tables, **kw)
    got = tcape.cape_cin(*(to_torch(x) for x in (p, t, td)),
                         parcel_pressure=to_torch(state[0]),
                         parcel_temperature=to_torch(state[1]),
                         parcel_dewpoint=to_torch(state[2]),
                         tables=tables, **kw)
    assert_same(want, got)
    assert (got[0]['cape'] > 1.0).sum() > 5
    assert_same(jcape.surface_based_cape_cin(
        *(jnp.asarray(x) for x in (p, t, td)), tables=jax_tables, **kw),
        tcape.surface_based_cape_cin(*(to_torch(x) for x in (p, t, td)),
                                     tables=tables, **kw))


@pytest.mark.parametrize('fn', ['most_unstable_cape_cin',
                                'mixed_layer_cape_cin'])
@pytest.mark.parametrize('backend', BACKENDS)
def test_parcel_variant_solves(jax_tables, tables, fn, backend):
    p, t, td = hard(24, 20, seed=5)
    jml, tml = BACKENDS[backend]
    want = jax.jit(lambda *a: getattr(jparcels, fn)(
        *a, tables=jax_tables, moist_lapse=jml))(
        *(jnp.asarray(x) for x in (p, t, td)))
    got = getattr(tparcels, fn)(*(to_torch(x) for x in (p, t, td)),
                                tables=tables, moist_lapse=tml)
    assert_same(want, got)


def test_mixed_layer_per_variable():
    """Without a shared mask each variable mixes over its own valid
    levels."""
    p, t, td = hard()
    t[8, 1:3] = np.nan                         # NaN values at valid levels
    fields = {'pressure': p, 'temperature': t, 'dewpoint': td}
    for depth in (50.0, 100.0):
        assert_same(
            jparcels.mixed_layer({k: jnp.asarray(v)
                                  for k, v in fields.items()}, depth=depth),
            tparcels.mixed_layer({k: to_torch(v)
                                  for k, v in fields.items()}, depth=depth))


# --- diagnostics -------------------------------------------------------------

def test_isobar_temperature():
    p, t, _ = hard()
    for isobar in (850.0, 500.0, 1100.0):
        assert_same(*both(jdiag.isobar_temperature, tdiag.isobar_temperature,
                          p, t, isobar=isobar))


@pytest.mark.parametrize('backend', ['integrate', 'tables'])
def test_wet_bulb_temperature(jax_tables, tables, backend):
    p, t, td = hard(12, 8)
    t[0, 0] = 400.0                            # outside the curve family
    p[1, 1] = 1200.0                           # outside the grid
    jml, tml = ((None, None) if backend == 'integrate' else
                (jad.moist_lapse, tad.moist_lapse))
    want = jdiag.wet_bulb_temperature(*(jnp.asarray(x) for x in (p, t, td)),
                                      tables=jax_tables, moist_lapse=jml)
    got = tdiag.wet_bulb_temperature(*(to_torch(x) for x in (p, t, td)),
                                     tables=tables, moist_lapse=tml)
    assert_same(want, got)
    assert torch.isnan(got[0, 0]) and torch.isnan(got[1, 1])


def test_melting_level_exact_wet_bulb():
    dat = make_inputs(ny=2, nx=3, L=20, seed=12)
    p, t, h = dat['pressure'], dat['temperature'], dat['height_asl']
    td = np.asarray(jthermo.dewpoint_from_specific_humidity(
        p, t, dat['specific_humidity']))
    assert_same(*both(jdiag.melting_level_height, tdiag.melting_level_height,
                      p, t, td, h, fast=False))


# --- pipelines ---------------------------------------------------------------

def grid():
    """A 4 x 5 grid of 36-level columns with poisoned columns."""
    dat = make_inputs(ny=4, nx=5, L=36, seed=11)
    dat['specific_humidity'][2, 3, 7] = np.nan
    dat['pressure'][3, 1, -1] = np.nan
    return dat


@pytest.fixture(scope='module')
def modular(jax_tables, tables):
    """JAX's and the port's modular pipelines on :func:`grid`, and the
    port's fused ones (both mixed-layer modes)."""
    dat = grid()
    jdat = {k: jnp.asarray(v) for k, v in dat.items()}
    tdat = {k: to_torch(v) for k, v in dat.items()}
    out = {}
    for name in ('conv_properties', 'min_conv_properties'):
        # Compiled once: far quicker on the CPU than op by op.
        want = jax.jit(lambda d, fn=getattr(jpipeline, name): fn(
            d, tables=jax_tables))(jdat)
        out[name] = ({k: np.asarray(v) for k, v in want.items()},
                     getattr(tpipeline, name)(tdat, tables=tables))
    out['fused'] = tpipeline.conv_properties_fused(tdat, tables=tables)
    out['fused_grow'] = tpipeline.conv_properties_fused(tdat, tables=tables,
                                                        mix_grow=True)
    out['min_fused'] = tpipeline.min_conv_properties_fused(tdat,
                                                           tables=tables)
    return out


def assert_pipeline_key(want, got, key):
    a, b = want[key], got[key]
    assert b.shape == (4, 5)
    scale = max(1.0, float(np.nanmax(np.abs(a)))) if a.dtype != bool else 1
    assert_same(a, b, atol=1e-6 * scale, rtol=0, name=key)


def test_modular_variable_sets(modular):
    want, got = modular['conv_properties']
    assert set(got) == set(want) == set(OUTPUTS)
    want, got = modular['min_conv_properties']
    assert set(got) == set(want) == set(MIN_OUTPUTS)


@pytest.mark.parametrize('key', OUTPUTS)
def test_conv_properties_matches_jax(modular, key):
    assert_pipeline_key(*modular['conv_properties'], key)


@pytest.mark.parametrize('key', MIN_OUTPUTS)
def test_min_conv_properties_matches_jax(modular, key):
    assert_pipeline_key(*modular['min_conv_properties'], key)


@pytest.mark.parametrize('fused', ['fused', 'fused_grow'])
def test_fused_pipeline_matches_modular(modular, fused):
    """As ``test_fused_pipeline.py`` holds the JAX package's: identical
    NaN patterns, atol 1e-6, rtol 1e-9."""
    _, ref = modular['conv_properties']
    got = modular[fused]
    assert set(got) == set(ref)
    for k in ref:
        a, b = got[k].numpy(), ref[k].numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, rtol=1e-9, err_msg=k)


def test_min_fused_pipeline_matches_modular(modular):
    _, ref = modular['min_conv_properties']
    got = modular['min_fused']
    assert set(got) == set(ref)
    for k in ref:
        assert_same(ref[k].numpy(), got[k], atol=1e-6, rtol=1e-9, name=k)


@pytest.fixture(scope='module')
def archive(tables):
    with np.load(ARCHIVE) as f:
        inputs = {k[3:]: f[k] for k in f.files if k.startswith('in_')}
        expect = {k[4:]: f[k] for k in f.files if k.startswith('out_')}
    dat = {k: to_torch(v) for k, v in inputs.items()}
    got = tpipeline.conv_properties(dat, tables=tables)
    got.update(tpipeline.storm_proxies(got))
    got.update({f'min.{k}': v for k, v in
                tpipeline.min_conv_properties(dat, tables=tables).items()})
    return expect, got


def test_archive_variable_set(archive):
    expect, got = archive
    assert set(got) == set(expect)


@pytest.mark.parametrize('key', OUTPUTS + PROXIES +
                         [f'min.{k}' for k in MIN_OUTPUTS])
def test_modular_regression_archive(archive, key):
    """The archive test's own bounds: identical NaN patterns, atol 1e-4 of
    the variable's scale, rtol 1e-6."""
    expect, got = archive
    a, b = got[key].numpy(), expect[key]
    if b.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=key)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
    scale = max(1.0, float(np.nanmax(np.abs(b))) * 1e-6)
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               atol=1e-4 * scale, rtol=1e-6, err_msg=key)


def test_devices_must_match(tables):
    p, t, td = (to_torch(x) for x in hard(4, 6))
    with pytest.raises(ValueError, match='meta'):
        tprofile.parcel_profile(p, p[:, 0].to('meta'), t[:, 0], td[:, 0],
                                tables=tables)
