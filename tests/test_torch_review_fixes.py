"""The port under the regression tests of ``test_review_fixes.py``:

1. ``lfc_el(intersections_in_log=True)`` without a precomputed crossing set
   builds the set in log space and agrees with the linear default (LFC
   727.371 hPa on the reference's profile), and with the JAX package's
   ``lfc_el`` in both modes;
2. the first-level parcel == environment rule is ulp-tolerant;
3. ``mixed_parcel`` anchors at the first valid level, so a NaN bottom slot
   gives the compacted column's parcel in both ``mix_layer`` modes;
4. mixed-layer CAPE/CIN on a leading-NaN column equals the compacted
   column's;
5. ``ops.compact_left`` promotes int and bool fields to float32;
6. ``adiabat._stored_dtype`` reads the ``.npy`` header only and returns
   None for unreadable files.

The same soundings and tolerances, on the port's float64 CPU path.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_allclose, assert_almost_equal

from xarray_parcel_tpu import api as japi
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu_torch import adiabat, api, ops, parcels
from xarray_parcel_tpu_torch.cape import lfc_el

ORACLE = dict(moist_lapse=adiabat.moist_lapse_integrate)

LEVELS = np.array([959., 779.2, 751.3, 724.3, 700., 269.])
TEMPS = np.array([22.2, 14.6, 12., 9.4, 7., -49.]) + 273.15
DEWS = np.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15


def T(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _profile():
    levels, temps, dews = T(LEVELS), T(TEMPS), T(DEWS)
    return api.parcel_profile_with_lcl(
        pressure=levels, temperature=temps, dewpoint=dews,
        parcel_pressure=levels[0], parcel_temperature=temps[0],
        parcel_dewpoint=dews[0], lcl_interp='linear', **ORACLE)


def test_lfc_el_self_built_log_intersections():
    prof = _profile()
    args = (prof['pressure'], prof['temperature'],
            prof['environment_temperature'], prof['lcl_pressure'],
            prof['lcl_temperature'])
    lin = lfc_el(*args)
    log = lfc_el(*args, intersections_in_log=True)
    assert_allclose(float(np.exp(log['_lfc_log_pressure'].numpy())),
                    float(log['lfc_pressure']), rtol=1e-14)
    for k in ('lfc_pressure', 'lfc_temperature', 'el_pressure',
              'el_temperature'):
        assert_allclose(log[k].numpy(), lin[k].numpy(), rtol=1e-12,
                        err_msg=k)
    assert_almost_equal(float(lin['lfc_pressure']), 727.371, 2)
    # The JAX package's lfc_el on the same tracks, in both modes.
    jargs = [jnp.asarray(a.numpy()) for a in args]
    for kw, got in ((dict(), lin), (dict(intersections_in_log=True), log)):
        want = jcape.lfc_el(*jargs, **kw)
        assert set(want) == set(got)
        for k in want:
            assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12,
                            err_msg=f'{kw} {k}')


def test_same_first_level_rule_is_ulp_tolerant():
    prof = _profile()
    pt = prof['temperature'].numpy().astype(np.float32)
    args_exact = (T(prof['pressure'], torch.float32), T(pt, torch.float32),
                  T(prof['environment_temperature'], torch.float32),
                  T(prof['lcl_pressure'], torch.float32),
                  T(prof['lcl_temperature'], torch.float32))
    exact = lfc_el(*args_exact)
    pt_ulp = pt.copy()
    pt_ulp[..., 0] = np.nextafter(np.nextafter(pt_ulp[..., 0],
                                               np.float32(np.inf)),
                                  np.float32(np.inf))
    wobbled = lfc_el(args_exact[0], T(pt_ulp, torch.float32),
                     *args_exact[2:])
    assert_allclose(wobbled['lfc_pressure'].numpy(),
                    exact['lfc_pressure'].numpy(), rtol=1e-5)
    pt_diff = pt.copy()
    pt_diff[..., 0] += 0.1
    tol = 8 * np.finfo(np.float32).eps * np.abs(pt_diff[..., 0])
    assert np.all(np.abs(pt_diff[..., 0] - pt[..., 0]) > tol)


def _padded():
    return (T(np.concatenate([[np.nan], LEVELS])),
            T(np.concatenate([[np.nan], TEMPS])),
            T(np.concatenate([[np.nan], DEWS])))


def test_mixed_parcel_nan_bottom_slot():
    p, t, td = _padded()
    mp_pad = parcels.mixed_parcel(p, t, td)
    mp_ref = parcels.mixed_parcel(T(LEVELS), T(TEMPS), T(DEWS))
    for k in mp_ref:
        assert torch.isfinite(mp_pad[k]).all(), k
        assert_allclose(mp_pad[k].numpy(), mp_ref[k].numpy(), rtol=1e-12,
                        err_msg=k)
    grown, _ = parcels.mix_layer(p, t, td, grow=True)
    slotted, _ = parcels.mix_layer(p, t, td, grow=False)
    for fields in (grown, slotted):
        assert torch.isfinite(fields['pressure']).sum() > 0
    gp, gt = (grown[k].numpy() for k in ('pressure', 'temperature'))
    sp, st = (slotted[k].numpy() for k in ('pressure', 'temperature'))
    assert_allclose(gp[np.isfinite(gp)], sp[np.isfinite(sp)], rtol=1e-12)
    assert_allclose(gt[np.isfinite(gp)], st[np.isfinite(sp)], rtol=1e-12)


def test_mixed_layer_cape_cin_nan_bottom_matches_compacted():
    res_pad, _, _ = parcels.mixed_layer_cape_cin(*_padded(), **ORACLE)
    res_ref, _, _ = parcels.mixed_layer_cape_cin(T(LEVELS), T(TEMPS),
                                                 T(DEWS), **ORACLE)
    for k in ('cape', 'cin'):
        assert_allclose(float(res_pad[k]), float(res_ref[k]), rtol=1e-10,
                        atol=1e-8, err_msg=k)


def test_compact_left_promotes_int_and_bool():
    out = ops.compact_left(
        {'pressure': T([[np.nan, 1000.0, 900.0]]),
         'flag': torch.tensor([[7, 8, 9]], dtype=torch.int32),
         'ok': torch.tensor([[True, False, True]])}, 'pressure')
    assert out['flag'].dtype == torch.float32
    assert out['ok'].dtype == torch.float32
    assert_allclose(out['flag'].numpy()[0, :2], [8.0, 9.0])
    assert np.isnan(out['flag'].numpy()[0, 2])
    assert np.isnan(out['ok'].numpy()[0, 2])
    # As the JAX package's does.
    jout = japi.compact_left(
        {'pressure': jnp.asarray([[np.nan, 1000.0, 900.0]]),
         'flag': jnp.asarray([[7, 8, 9]], jnp.int32)}, 'pressure')
    np.testing.assert_array_equal(np.asarray(jout['flag']),
                                  out['flag'].numpy())


def test_stored_dtype_header_only(tmp_path):
    path = os.path.join(tmp_path, 'tables.npz')
    np.savez_compressed(path, curves=np.zeros((3, 4), np.float32),
                        lookup=np.zeros((2, 2), np.float32),
                        coeffs=np.zeros((1,), np.float32))
    assert adiabat._stored_dtype(path) == np.float32
    bad = os.path.join(tmp_path, 'bad.npz')
    with open(bad, 'wb') as fh:
        fh.write(b'not a zip')
    assert adiabat._stored_dtype(bad) is None
    assert adiabat._stored_dtype(os.path.join(tmp_path, 'nope.npz')) is None
