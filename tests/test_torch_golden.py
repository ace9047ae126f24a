"""The port against the golden MetPy truths of ``test_golden_metpy.py``.

The same soundings, the same truth values and the same per-test decimals as
that file, run through the PyTorch port in float64 on the CPU.  As there,
the exact-ODE moist-lapse oracle (``adiabat.moist_lapse_integrate``) stands
in for the table consumer.  ``lfc_el`` and ``cape_cin_base`` are called
with the JAX package's signatures, on linear pressures.

Attribution: the truth constants (expected values, soundings, tolerances)
in this file derive from MetPy's test suite (Copyright 2008-2023 MetPy
Developers, BSD 3-Clause) via the reference's modules/unit_tests.py, as
those of ``tests/test_golden_metpy.py`` do -- see the repository NOTICE
file.  The test code itself is freshly written.
"""

import numpy as np
import torch
from numpy.testing import assert_almost_equal, assert_array_almost_equal

from xarray_parcel_tpu_torch import adiabat, cape, diagnostics, ops, parcels
from xarray_parcel_tpu_torch import profile
from xarray_parcel_tpu_torch.lcl import lcl

ORACLE = dict(moist_lapse=adiabat.moist_lapse_integrate)
MP = dict(virtual_temperature_correction=False, lcl_interp='linear',
          **ORACLE)


def T(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def f(x):
    return float(np.asarray(x).reshape(-1)[0])


def arr(x):
    return x.numpy()


def profile_with_lcl(levels, temps, dews, parcel=None, lcl_interp='linear'):
    levels, temps, dews = T(levels), T(temps), T(dews)
    if parcel is None:
        parcel = (levels[0], temps[0], dews[0])
    return profile.parcel_profile_with_lcl(
        levels, temps, dews, parcel_pressure=parcel[0],
        parcel_temperature=parcel[1], parcel_dewpoint=parcel[2],
        lcl_interp=lcl_interp, **ORACLE)


def run_lfc_el(prof):
    """``lfc_el`` on a profile's pressure, parcel temperature and
    environment temperature tracks and its LCL, as the JAX golden tests
    call it."""
    return cape.lfc_el(pressure=prof['pressure'],
                       parcel_temperature=prof['temperature'],
                       temperature=prof['environment_temperature'],
                       lcl_pressure=prof['lcl_pressure'],
                       lcl_temperature=prof['lcl_temperature'])


# ----------------------------------------------------------------- moist/dry

def test_moist_lapse_oracle():
    temp = adiabat.moist_lapse_integrate(T([1000., 800., 600., 500., 400.]),
                                         293.0)
    assert_array_almost_equal(arr(temp),
                              [293, 284.64, 272.81, 264.42, 252.91], 2)


def test_moist_lapse_ref_pres_oracle():
    temp = adiabat.moist_lapse_integrate(T([1050., 800., 600., 500., 400.]),
                                         293.0, 1000.0)
    assert_array_almost_equal(arr(temp),
                              [294.76, 284.64, 272.81, 264.42, 252.91], 2)


def test_moist_lapse_uniform_oracle():
    temp = adiabat.moist_lapse_integrate(T([900., 900., 900.]), 293.15)
    assert_array_almost_equal(arr(temp), [293.15] * 3, 7)


# ----------------------------------------------------------------------- lcl

def test_lcl():
    r = lcl(T(1000.0), T(30 + 273.15), T(20 + 273.15))
    assert_almost_equal(f(r['lcl_pressure']), 864.806, 2)
    assert_almost_equal(f(r['lcl_temperature']), 17.676 + 273.15, 2)


def test_lcl_nans():
    r = lcl(T([900., 900., 900., 900.]),
            T([np.nan, 25., 25., 25.]) + 273.15,
            T([20., 20., np.nan, 20.]) + 273.15)
    assert_array_almost_equal(
        arr(r['lcl_pressure']),
        [np.nan, 836.4098648012595, np.nan, 836.4098648012595], 4)
    assert_array_almost_equal(
        arr(r['lcl_temperature']),
        np.array([np.nan, 18.82281982535794, np.nan,
                  18.82281982535794]) + 273.15, 4)


def test_lcl_convergence_issue():
    p = T([990., 973., 931., 925., 905.])
    t = T([14.4, 14.2, 13, 12.6, 11.4]) + 273.15
    d = T([14.4, 11.7, 8.2, 7.8, 7.6]) + 273.15
    assert_almost_equal(f(lcl(p[0], t[0], d[0])['lcl_pressure']), 990, 0)


def test_lcl_grid_surface_lcls():
    r = lcl(T([1000., 990., 1010.]), T([15., 14., 13.]) + 273.15,
            T([15., 10., 13.]) + 273.15)
    assert_array_almost_equal(arr(r['lcl_pressure']),
                              [1000, 932.1719, 1010], 4)
    assert_array_almost_equal(arr(r['lcl_temperature']),
                              np.array([15, 9.10424, 13]) + 273.15, 4)


# ------------------------------------------------------------------ profiles

def test_parcel_profile():
    levels = T([1000., 900., 800., 700., 600., 500., 400.])
    true_prof = np.array([303.15, 294.16, 288.026, 283.073, 277.058, 269.402,
                          258.966])
    prof = profile.parcel_profile(levels, 1000.0, 303.15, 293.15, **ORACLE)
    assert_array_almost_equal(arr(prof['temperature']), true_prof, 2)


def test_parcel_profile_lcl():
    p = T([1004., 1000., 943., 928., 925., 850., 839., 749., 700., 699.])
    t = T([24.2, 24., 20.2, 21.6, 21.4, 20.4, 20.2, 14.4, 13.2, 13.]) + 273.15
    true_t = np.array([24.2, 24., 22.047, 20.2, 21.6, 21.4, 20.4, 20.2, 14.4,
                       13.2, 13.]) + 273.15
    true_p = np.array([1004., 1000., 970.711, 943., 928., 925., 850., 839.,
                       749., 700., 699.])
    true_prof = np.array([297.35, 297.01, 294.5, 293.48, 292.92, 292.81,
                          289.79, 289.32, 285.15, 282.59, 282.53])
    prof = profile.parcel_profile(p, 1004.0, 24.2 + 273.15, 21.9 + 273.15,
                                  **ORACLE)
    prof = profile.add_lcl_to_profile(
        prof, environment={'temperature': t, 'pressure': prof['pressure']},
        interpolator='linear')
    assert_array_almost_equal(arr(prof['pressure']), true_p, 3)
    assert_array_almost_equal(arr(prof['environment_temperature']),
                              true_t, 3)
    assert_array_almost_equal(arr(prof['temperature']), true_prof, 2)


def test_parcel_profile_saturated():
    prof = profile.parcel_profile(T([1000., 700., 500.]), 1000.0,
                                  23.8 + 273.15, 23.8 + 273.15, **ORACLE)
    assert_array_almost_equal(arr(prof['temperature']),
                              [296.95, 284.381, 271.123], 2)


def test_parcel_profile_below_lcl():
    p = T([981, 949.2, 925., 913.9, 903, 879.4, 878, 864, 855, 850, 846.3,
           838, 820, 814.5, 799, 794.])
    truth = np.array([276.35, 273.760341, 271.747753, 270.812026, 269.885225,
                      267.850849, 267.728946, 266.502214, 265.706084,
                      265.261201, 264.930782, 264.185801, 262.551884,
                      262.047526, 260.61294, 260.145932])
    prof = profile.parcel_profile(p, p[0], 3.2 + 273.15, -10.8 + 273.15,
                                  **ORACLE)
    assert_array_almost_equal(arr(prof['temperature']), truth, 6)


# ------------------------------------------------------------------- lfc/el

def test_lfc_basic():
    levels = [959., 779.2, 751.3, 724.3, 700., 269.]
    temps = np.array([22.2, 14.6, 12., 9.4, 7., -49.]) + 273.15
    dews = np.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert_almost_equal(f(lfc['lfc_pressure']), 727.371, 2)
    assert_almost_equal(f(lfc['lfc_temperature']), 9.705 + 273.15, 2)


def _mixed(levels, temps, dews):
    m = parcels.mixed_parcel(T(levels), T(temps), T(dews))
    return m['pressure'], m['temperature'], m['dewpoint']


def test_lfc_ml():
    levels = [959., 779.2, 751.3, 724.3, 700., 269.]
    temps = np.array([22.2, 14.6, 12., 9.4, 7., -49.]) + 273.15
    dews = np.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    prof = profile_with_lcl(levels, temps, dews,
                            parcel=_mixed(levels, temps, dews))
    lfc = run_lfc_el(prof)
    assert_almost_equal(f(lfc['lfc_pressure']), 601.225, 2)
    assert_almost_equal(f(lfc['lfc_temperature']), -1.90688 + 273.15, 2)


def test_lfc_ml2():
    levels = [
        1024.95703125, 1016.61474609, 1005.33056641, 991.08544922,
        973.4163208, 951.3381958, 924.82836914, 898.25482178, 873.46124268,
        848.69830322, 823.92553711, 788.49304199, 743.44580078, 700.50970459,
        659.62017822, 620.70861816, 583.69421387, 548.49719238, 515.03826904,
        483.24401855, 453.0418396, 424.36477661, 397.1505127, 371.33441162,
        346.85922241, 323.66995239, 301.70935059, 280.92651367, 261.27053833,
        242.69168091, 225.14237976, 208.57781982, 192.95333862, 178.22599792,
        164.39630127, 151.54336548, 139.68635559, 128.74923706, 118.6588974,
        109.35111237, 100.76405334, 92.84288025, 85.53556824, 78.79430389,
        72.57549286, 66.83885193, 61.54678726, 56.66480637, 52.16108322]
    temps = np.array([
        6.00750732, 5.14892578, 4.177948, 3.00268555, 1.55535889,
        -0.25527954, -1.93988037, -3.57766724, -4.40600586, -4.19238281,
        -3.71185303, -4.47943115, -6.81280518, -8.08685303, -8.41287231,
        -10.79302979, -14.13262939, -16.85784912, -19.51675415, -22.28689575,
        -24.99938965, -27.79664612, -30.90414429, -34.49435425, -38.438797,
        -42.27981567, -45.99230957, -49.75340271, -53.58230591, -57.30686951,
        -60.76026917, -63.92070007, -66.72470093, -68.97846985, -70.4264679,
        -71.16407776, -71.53797913, -71.64375305, -71.52735901, -71.53523254,
        -71.61097717, -71.92687988, -72.68682861, -74.129776, -76.02471924,
        -76.88977051, -76.26008606, -75.90351868, -76.15809631]) + 273.15
    dews = np.array([
        4.50012302, 3.42483997, 2.78102994, 2.24474645, 1.593485, -0.9440815,
        -3.8044982, -3.55629468, -9.7376976, -10.2950449, -9.67498302,
        -10.30486488, -8.70559597, -8.71669006, -12.66509628, -18.6697197,
        -23.00351334, -29.46240425, -36.82178497, -41.68824768, -44.50320816,
        -48.54426575, -52.50753403, -51.09564209, -48.92690659, -49.97380829,
        -51.57516098, -52.62096405, -54.24332809, -57.09109879, -60.5596199,
        -63.93486404, -67.07530212, -70.01263428, -72.9258728, -76.12271881,
        -79.49847412, -82.2350769, -83.91127014, -84.95665741, -85.61238861,
        -86.16391754, -86.7653656, -87.34436035, -87.87495422, -88.34281921,
        -88.74453735, -89.04680634, -89.26436615]) + 273.15
    prof = profile_with_lcl(levels, temps, dews,
                            parcel=_mixed(levels, temps, dews))
    lfc = run_lfc_el(prof)
    assert_almost_equal(f(lfc['lfc_pressure']), 962.34, 2)
    assert_almost_equal(f(lfc['lfc_temperature']), 0.767 + 273.15, 2)


def test_lfc_intersection():
    levels = T([1024.957, 930., 924.828, 898.255, 873.461, 848.698, 823.926,
                788.493])
    temps = T([6.008, -10., -6.94, -8.58, -4.41, -4.19, -3.71,
               -4.48]) + 273.15
    dews = T([5., -10., -7., -9., -4.5, -4.2, -3.8, -4.5]) + 273.15
    mixed = parcels.mixed_parcel(levels, temps, dews)
    prof = profile.parcel_profile(levels, mixed['pressure'],
                                  mixed['temperature'], mixed['dewpoint'],
                                  **ORACLE)
    prof['environment_temperature'] = temps
    lfc = run_lfc_el(prof)
    assert_almost_equal(f(lfc['lfc_pressure']), 981.620, 2)


def test_no_lfc():
    levels = [959., 867.9, 779.2, 647.5, 472.5, 321.9, 251.]
    temps = np.array([22.2, 17.4, 14.6, 1.4, -17.6, -39.4, -52.5]) + 273.15
    dews = np.array([9., 4.3, -21.2, -26.7, -31., -53.3, -66.7]) + 273.15
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert np.isnan(f(lfc['lfc_pressure']))
    assert np.isnan(f(lfc['lfc_temperature']))


def test_lfc_inversion():
    levels = [963., 789., 782.3, 754.8, 728.1, 727., 700., 571., 450., 300.,
              248.]
    temps = np.array([25.4, 18.4, 17.8, 15.4, 12.9, 12.8, 10., -3.9, -16.3,
                      -41.1, -51.5]) + 273.15
    dews = np.array([20.4, 0.4, -0.5, -4.3, -8., -8.2, -9., -23.9, -33.3,
                     -54.1, -63.5]) + 273.15
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert_almost_equal(f(lfc['lfc_pressure']), 705.8806, 2)
    assert_almost_equal(f(lfc['lfc_temperature']), 10.6232 + 273.15, 2)


def test_lfc_equals_lcl():
    levels = [912., 905.3, 874.4, 850., 815.1, 786.6, 759.1, 748., 732.2,
              700., 654.8]
    temps = np.array([29.4, 28.7, 25.2, 22.4, 19.4, 16.8, 14.0, 13.2, 12.6,
                      11.4, 7.1]) + 273.15
    dews = np.array([18.4, 18.1, 16.6, 15.4, 13.2, 11.4, 9.6, 8.8, 0., -18.6,
                     -22.9]) + 273.15
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert_almost_equal(f(lfc['lfc_pressure']), 777.0786, 2)
    assert_almost_equal(f(lfc['lfc_temperature']), 15.8714 + 273.15, 2)


def _sensitive_sounding():
    levels = [1004., 1000., 943., 928., 925., 850., 839., 749., 700., 699.,
              603., 500., 404., 400., 363., 306., 300., 250., 213., 200.,
              176., 150.]
    temps = np.array([24.2, 24., 20.2, 21.6, 21.4, 20.4, 20.2, 14.4, 13.2,
                      13., 6.8, -3.3, -13.1, -13.7, -17.9, -25.5, -26.9,
                      -37.9, -46.7, -48.7, -52.1, -58.9]) + 273.15
    dews = np.array([21.9, 22.1, 19.2, 20.5, 20.4, 18.4, 17.4, 8.4, -2.8,
                     -3.0, -15.2, -20.3, -29.1, -27.7, -24.9, -39.5, -41.9,
                     -51.9, -60.7, -62.7, -65.1, -71.9]) + 273.15
    return levels, temps, dews


def test_sensitive_sounding_mp():
    levels, temps, dews = _sensitive_sounding()
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert_almost_equal(f(lfc['lfc_pressure']), 947.422, 2)
    assert_almost_equal(f(lfc['lfc_temperature']), 20.498 + 273.15, 2)
    res, _ = cape.surface_based_cape_cin(T(levels), T(temps), T(dews), **MP)
    assert_almost_equal(f(res['cape']), 0.1115, 3)
    assert_almost_equal(f(res['cin']), -6.0866, 3)


def test_sensitive_sounding():
    res, _ = cape.surface_based_cape_cin(
        *(T(x) for x in _sensitive_sounding()), **ORACLE)
    assert_almost_equal(f(res['cape']), 0.5961, 3)
    assert_almost_equal(f(res['cin']), -5.1399, 3)


def test_lfc_sfc_precision():
    levels = [839., 819.4, 816., 807., 790.7, 763., 736.2, 722., 710.1, 700.]
    temps = np.array([20.6, 22.3, 22.6, 22.2, 20.9, 18.7, 16.4, 15.2, 13.9,
                      12.8]) + 273.15
    dews = np.array([10.6, 8., 7.6, 6.2, 5.7, 4.7, 3.7, 3.2, 3.,
                     2.8]) + 273.15
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert np.isnan(f(lfc['lfc_pressure']))
    assert np.isnan(f(lfc['lfc_temperature']))


def _sounding_1003():
    levels = [902.1554, 897.9034, 893.6506, 889.4047, 883.063, 874.6284,
              866.2387, 857.887, 849.5506, 841.2686, 833.0042, 824.7891,
              812.5049, 796.2104, 776.0027, 751.9025, 727.9612, 704.1409,
              680.4028, 656.7156, 629.077, 597.4286, 565.6315, 533.5961,
              501.2452, 468.493, 435.2486, 401.4239, 366.9387, 331.7026,
              295.6319, 258.6428, 220.9178, 182.9384, 144.959, 106.9778,
              69.00213]
    temps = np.array([-3.039381, -3.703779, -4.15996, -4.562574, -5.131827,
                      -5.856229, -6.568434, -7.276881, -7.985013, -8.670911,
                      -8.958063, -7.631381, -6.05927, -5.083627, -5.11576,
                      -5.687552, -5.453021, -4.981445, -5.236665, -6.324916,
                      -8.434324, -11.58795, -14.99297, -18.45947, -21.92021,
                      -25.40522, -28.914, -32.78637, -37.7179, -43.56836,
                      -49.61077, -54.24449, -56.16666, -57.03775, -58.28041,
                      -60.86264, -64.21677]) + 273.15
    dews = np.array([-22.08774, -22.18181, -22.2508, -22.31323, -22.4024,
                     -22.51582, -22.62526, -22.72919, -22.82095, -22.86173,
                     -22.49489, -21.66936, -21.67332, -21.94054, -23.63561,
                     -27.17466, -31.87395, -38.31725, -44.54717, -46.99218,
                     -43.17544, -37.40019, -34.3351, -36.42896, -42.1396,
                     -46.95909, -49.36232, -48.94634, -47.90178, -49.97902,
                     -55.02753, -63.06276, -72.53742, -88.81377, -93.54573,
                     -92.92464, -91.57479]) + 273.15
    return levels, temps, dews


def test_lfc_pos_area_below_lcl():
    lfc = run_lfc_el(profile_with_lcl(*_sounding_1003()))
    assert np.isnan(f(lfc['lfc_pressure']))
    assert np.isnan(f(lfc['lfc_temperature']))


def test_el():
    levels = [959., 779.2, 751.3, 724.3, 700., 269.]
    temps = np.array([22.2, 14.6, 12., 9.4, 7., -38.]) + 273.15
    dews = np.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    # 2 decimals on el_pressure, as test_golden_metpy.py (the truth bakes
    # in MetPy's ODE-solver residual).
    assert_almost_equal(f(el['el_pressure']), 471.83286, 2)
    assert_almost_equal(f(el['el_temperature']), -11.5603 + 273.15, 3)


def test_el_ml():
    levels = [959., 779.2, 751.3, 724.3, 700., 400., 269.]
    temps = np.array([22.2, 14.6, 12., 9.4, 7., -25., -35.]) + 273.15
    dews = np.array([19., -11.2, -10.8, -10.4, -10., -35., -53.2]) + 273.15
    prof = profile_with_lcl(levels, temps, dews,
                            parcel=_mixed(levels, temps, dews))
    el = run_lfc_el(prof)
    assert_almost_equal(f(el['el_pressure']), 350.0561, 3)
    assert_almost_equal(f(el['el_temperature']), -28.36156 + 273.15, 3)


def test_no_el():
    levels = [959., 867.9, 779.2, 647.5, 472.5, 321.9, 251.]
    temps = np.array([22.2, 17.4, 14.6, 1.4, -17.6, -39.4, -52.5]) + 273.15
    dews = np.array([19., 14.3, -11.2, -16.7, -21., -43.3, -56.7]) + 273.15
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert np.isnan(f(el['el_pressure']))
    assert np.isnan(f(el['el_temperature']))


def test_no_el_multi_crossing():
    levels = [918., 911., 880., 873.9, 850., 848., 843.5, 818., 813.8, 785.,
              773., 763., 757.5, 730.5, 700., 679., 654.4, 645., 643.9]
    temps = np.array([24.2, 22.8, 19.6, 19.1, 17., 16.8, 16.5, 15., 14.9,
                      14.4, 16.4, 16.2, 15.7, 13.4, 10.6, 8.4, 5.7, 4.6,
                      4.5]) + 273.15
    dews = np.array([19.5, 17.8, 16.7, 16.5, 15.8, 15.7, 15.3, 13.1, 12.9,
                     11.9, 6.4, 3.2, 2.6, -0.6, -4.4, -6.6, -9.3, -10.4,
                     -10.5]) + 273.15
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert np.isnan(f(el['el_pressure']))
    assert np.isnan(f(el['el_temperature']))


def test_lfc_and_el_below_lcl():
    dews = [264.5351, 261.13443, 259.0122, 252.30063, 248.58017, 242.66582]
    temps = [273.09723, 268.40173, 263.56207, 260.257, 256.63538, 252.91345]
    levels = [1017.16, 950, 900, 850, 800, 750.]
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    for k in ('el_pressure', 'el_temperature', 'lfc_pressure',
              'lfc_temperature'):
        assert np.isnan(f(el[k])), k


def test_el_lfc_equals_lcl():
    levels = [912., 905.3, 874.4, 850., 815.1, 786.6, 759.1, 748., 732.3,
              700., 654.8, 606.8, 562.4, 501.8, 500., 482., 400., 393.3,
              317.1, 307., 300., 252.7, 250., 200., 199.3, 197., 190., 172.,
              156.6, 150., 122.9, 112., 106.2, 100.]
    temps = np.array([29.4, 28.7, 25.2, 22.4, 19.4, 16.8, 14.3, 13.2, 12.6,
                      11.4, 7.1, 2.2, -2.7, -10.1, -10.3, -12.4, -23.3,
                      -24.4, -38., -40.1, -41.1, -49.8, -50.3, -59.1, -59.1,
                      -59.3, -59.7, -56.3, -56.9, -57.1, -59.1, -60.1, -58.6,
                      -56.9]) + 273.15
    dews = np.array([18.4, 18.1, 16.6, 15.4, 13.2, 11.4, 9.6, 8.8, 0., -18.6,
                     -22.9, -27.8, -32.7, -40.1, -40.3, -42.4, -53.3, -54.4,
                     -68., -70.1, -70., -70., -70., -70., -70., -70., -70.,
                     -70., -70., -70., -70., -70., -70., -70.]) + 273.15
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert_almost_equal(f(el['el_pressure']), 175.7663, 3)
    assert_almost_equal(f(el['el_temperature']), -57.03994 + 273.15, 3)


def test_el_small_surface_instability():
    levels = [959., 931.3, 925., 899.3, 892., 867.9, 850., 814., 807.9, 790.,
              779.2, 751.3, 724.3, 700., 655., 647.5, 599.4, 554.7, 550.,
              500.]
    temps = np.array([22.2, 20.2, 19.8, 18.4, 18., 17.4, 17., 15.4, 15.4,
                      15.6, 14.6, 12., 9.4, 7., 2.2, 1.4, -4.2, -9.7, -10.3,
                      -14.9]) + 273.15
    dews = np.array([20., 18.5, 18.1, 17.9, 17.8, 15.3, 13.5, 6.4, 2.2,
                     -10.4, -10.2, -9.8, -9.4, -9., -15.8, -15.7, -14.8,
                     -14., -13.9, -17.9]) + 273.15
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert np.isnan(f(el['el_pressure']))
    assert np.isnan(f(el['el_temperature']))


def test_no_el_parcel_colder():
    levels = [974., 946., 925., 877.2, 866., 850., 814.6, 785., 756.6, 739.,
              729.1, 700., 686., 671., 641., 613., 603., 586., 571., 559.3,
              539., 533., 500., 491., 477.9, 413., 390., 378., 345., 336.]
    temps = np.array([10., 8.4, 7.6, 5.9, 7.2, 7.6, 6.8, 7.1, 7.7, 7.8, 7.7,
                      5.6, 4.6, 3.4, 0.6, -0.9, -1.1, -3.1, -4.7, -4.7, -6.9,
                      -7.5, -11.1, -10.9, -12.1, -20.5, -23.5, -24.7, -30.5,
                      -31.7]) + 273.15
    dews = np.array([8.9, 8.4, 7.6, 5.9, 7.2, 7., 5., 3.6, 0.3, -4.2, -12.8,
                     -12.4, -8.4, -8.6, -6.4, -7.9, -11.1, -14.1, -8.8,
                     -28.1, -18.9, -14.5, -15.2, -15.1, -21.6, -41.5, -45.5,
                     -29.6, -30.6, -32.1]) + 273.15
    el = run_lfc_el(profile_with_lcl(levels, temps, dews))
    assert np.isnan(f(el['el_pressure']))
    assert np.isnan(f(el['el_temperature']))


def test_el_below_lcl():
    el = run_lfc_el(profile_with_lcl(*_sounding_1003()))
    assert np.isnan(f(el['el_pressure']))
    assert np.isnan(f(el['el_temperature']))


def test_lfc_not_below_lcl():
    levels = [1002.5, 1001.7, 1001., 1000.3, 999.7, 999., 998.2, 977.9,
              966.2, 952.3, 940.6, 930.5, 919.8, 909.1, 898.9, 888.4, 878.3,
              868.1, 858., 848., 837.2, 827., 816.7, 805.4]
    temps = np.array([17.9, 17.9, 17.8, 17.7, 17.7, 17.6, 17.5, 16., 15.2,
                      14.5, 13.8, 13., 12.5, 11.9, 11.4, 11., 10.3, 9.7, 9.2,
                      8.7, 8., 7.4, 6.8, 6.1]) + 273.15
    dews = np.array([13.6, 13.6, 13.5, 13.5, 13.5, 13.5, 13.4, 12.5, 12.1,
                     11.8, 11.4, 11.3, 11., 9.3, 10., 8.7, 8.9, 8.6, 8.1,
                     7.6, 7., 6.5, 6., 5.4]) + 273.15
    lfc = run_lfc_el(profile_with_lcl(levels, temps, dews, lcl_interp='log'))
    assert_almost_equal(f(lfc['lfc_pressure']), 811.618879, 3)
    assert_almost_equal(f(lfc['lfc_temperature']), 6.48644650 + 273.15, 3)


def multiple_intersections():
    levels = [966., 937.2, 925., 904.6, 872.6, 853., 850., 836., 821., 811.6,
              782.3, 754.2, 726.9, 700., 648.9, 624.6, 601.1, 595., 587.,
              576., 555.7, 534.2, 524., 500., 473.3, 400., 384.5, 358., 343.,
              308.3, 300., 276., 273., 268.5, 250., 244.2, 233., 200.]
    temps = np.array([18.2, 16.8, 16.2, 15.1, 13.3, 12.2, 12.4, 14., 14.4,
                      13.7, 11.4, 9.1, 6.8, 4.4, -1.4, -4.4, -7.3, -8.1,
                      -7.9, -7.7, -8.7, -9.8, -10.3, -13.5, -17.1, -28.1,
                      -30.7, -35.3, -37.1, -43.5, -45.1, -49.9, -50.4,
                      -51.1, -54.1, -55., -56.7, -57.5]) + 273.15
    dews = np.array([16.9, 15.9, 15.5, 14.2, 12.1, 10.8, 8.6, 0., -3.6,
                     -4.4, -6.9, -9.5, -12., -14.6, -15.8, -16.4, -16.9,
                     -17.1, -27.9, -42.7, -44.1, -45.6, -46.3, -45.5, -47.1,
                     -52.1, -50.4, -47.3, -57.1, -57.9, -58.1, -60.9, -61.4,
                     -62.1, -65.1, -65.6, -66.7, -70.5]) + 273.15
    return levels, temps, dews


def test_multiple_lfcs_el_simple():
    lfc = run_lfc_el(profile_with_lcl(*multiple_intersections()))
    assert_almost_equal(f(lfc['lfc_pressure']), 884.14790, 3)
    assert_almost_equal(f(lfc['lfc_temperature']), 13.95707016 + 273.15, 3)
    assert_almost_equal(f(lfc['el_pressure']), 228.151466, 3)
    assert_almost_equal(f(lfc['el_temperature']), -56.81015490 + 273.15, 3)


# ------------------------------------------------------------------ cape/cin

def _basic_cape_sounding():
    levels = T([959., 779.2, 751.3, 724.3, 700., 269.])
    temps = T([22.2, 14.6, 12., 9.4, 7., -38.]) + 273.15
    dews = T([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    return levels, temps, dews


def _cape_cin_from_plain_profile(levels, temps, dews, offset=0.0):
    prof = profile.parcel_profile(levels, levels[0], temps[0], dews[0],
                                  **ORACLE)
    prof['temperature'] = prof['temperature'] + offset
    prof['environment_temperature'] = temps
    lfc = run_lfc_el(prof)
    return cape.cape_cin_base(levels, temps, lfc['lfc_pressure'],
                              lfc['el_pressure'], prof['temperature'])


def test_cape_cin():
    res = _cape_cin_from_plain_profile(*_basic_cape_sounding())
    assert_almost_equal(f(res['cape']), 75.05354, 2)
    assert_almost_equal(f(res['cin']), -89.890078, 2)


def test_cape_cin_no_el():
    levels = T([959., 779.2, 751.3, 724.3])
    temps = T([22.2, 14.6, 12., 9.4]) + 273.15
    dews = T([19., -11.2, -10.8, -10.4]) + 273.15
    res = _cape_cin_from_plain_profile(levels, temps, dews)
    assert_almost_equal(f(res['cape']), 0.08610409, 2)
    assert_almost_equal(f(res['cin']), -89.8900784, 2)


def test_cape_cin_no_lfc():
    levels = T([959., 779.2, 751.3, 724.3, 700., 269.])
    temps = T([22.2, 24.6, 22., 20.4, 18., -10.]) + 273.15
    dews = T([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    res = _cape_cin_from_plain_profile(levels, temps, dews)
    assert_almost_equal(f(res['cape']), 0.0, 2)
    assert_almost_equal(f(res['cin']), 0.0, 2)


def test_cape_cin_custom_profile():
    res = _cape_cin_from_plain_profile(*_basic_cape_sounding(), offset=5.0)
    assert_almost_equal(f(res['cape']), 1440.463208696, 2)
    assert_almost_equal(f(res['cin']), 0.0, 2)


def test_surface_based_cape_cin_mp():
    res, _ = cape.surface_based_cape_cin(*_basic_cape_sounding(), **MP)
    assert_almost_equal(f(res['cape']), 75.0535446, 2)
    assert_almost_equal(f(res['cin']), -136.685967, 2)


def test_surface_based_cape_cin():
    res, _ = cape.surface_based_cape_cin(*_basic_cape_sounding(), **ORACLE)
    assert_almost_equal(f(res['cape']), 230.1982, 2)
    assert_almost_equal(f(res['cin']), -58.0673, 2)


def test_cape_cin_value_error():
    levels = T([1012.0, 1009.0, 1002.0, 1000.0, 925.0, 896.0, 855.0, 850.0,
                849.0, 830.0, 775.0, 769.0, 758.0, 747.0, 741.0, 731.0, 712.0,
                700.0, 691.0, 671.0, 636.0, 620.0, 610.0, 601.0, 594.0, 587.0,
                583.0, 580.0, 571.0, 569.0, 554.0, 530.0, 514.0, 506.0, 502.0,
                500.0, 492.0, 484.0, 475.0, 456.0, 449.0, 442.0, 433.0, 427.0,
                400.0, 395.0, 390.0, 351.0, 300.0, 298.0, 294.0, 274.0,
                250.0])
    temps = T([27.8, 25.8, 24.2, 24, 18.8, 16, 13, 12.6, 12.6, 11.6, 9.2,
               8.6, 8.4, 9.2, 10, 9.4, 7.4, 6.2, 5.2, 3.2, -0.3, -2.3, -3.3,
               -4.5, -5.5, -6.1, -6.1, -6.1, -6.3, -6.3, -7.7, -9.5, -9.9,
               -10.3, -10.9, -11.1, -11.9, -12.7, -13.7, -16.1, -16.9, -17.9,
               -19.1, -19.9, -23.9, -24.7, -25.3, -29.5, -39.3, -39.7, -40.5,
               -44.3, -49.3]) + 273.15
    dews = T([19.8, 16.8, 16.2, 16, 13.8, 12.8, 10.1, 9.7, 9.7, 8.6, 4.2,
              3.9, 0.4, -5.8, -32, -34.6, -35.6, -34.8, -32.8, -10.8, -9.3,
              -10.3, -9.3, -10.5, -10.5, -10, -16.1, -19.1, -23.3, -18.3,
              -17.7, -20.5, -27.9, -32.3, -33.9, -34.1, -35.9, -26.7, -37.7,
              -43.1, -33.9, -40.9, -46.1, -34.9, -33.9, -33.7, -33.3, -42.5,
              -50.3, -49.7, -49.5, -58.3, -61.3]) + 273.15
    res, _ = cape.surface_based_cape_cin(levels, temps, dews, **MP)
    # cape at 2 decimals, as test_golden_metpy.py (MetPy's ODE-solver
    # residual is baked into the truth).
    assert_almost_equal(f(res['cape']), 2007.040698, 2)
    assert_almost_equal(f(res['cin']), 0.0, 3)


# ------------------------------------------------ parcels (mixed / unstable)

def test_most_unstable_parcel():
    ret = parcels.most_unstable_parcel(T([1000., 959., 867.9]),
                                       T([18.2, 22.2, 17.4]) + 273.15,
                                       T([19., 19., 14.3]) + 273.15,
                                       depth=100.0)
    assert_almost_equal(f(ret['pressure']), 959.0, 6)
    assert_almost_equal(f(ret['temperature']), 22.2 + 273.15, 6)
    assert_almost_equal(f(ret['dewpoint']), 19.0 + 273.15, 6)


def test_most_unstable_parcel_duplicate_pressure():
    ret = parcels.most_unstable_parcel(
        T([1000.0, 950.0, 900.0, 900.0, 850.0]),
        T([300.0, 297.0, 296.0, 298.0, 290.0]),
        T([295.0, 294.0, 295.5, 270.0, 280.0]), depth=300.0)
    assert_almost_equal(f(ret['pressure']), 900.0, 6)
    assert_almost_equal(f(ret['temperature']), 296.0, 6)
    assert_almost_equal(f(ret['dewpoint']), 295.5, 6)


def test_most_unstable_cape_cin_surface_mp():
    res, _, _ = parcels.most_unstable_cape_cin(*_basic_cape_sounding(), **MP)
    assert_almost_equal(f(res['cape']), 75.0535446, 2)
    assert_almost_equal(f(res['cin']), -136.685967, 2)


def test_most_unstable_cape_cin_surface():
    res, _, _ = parcels.most_unstable_cape_cin(*_basic_cape_sounding(),
                                               **ORACLE)
    assert_almost_equal(f(res['cape']), 230.1982, 2)
    assert_almost_equal(f(res['cin']), -58.0673, 2)


def test_profile_with_lcl_in_levels_mp():
    levels = T([959., 914.8213254198571, 779.2, 751.3, 724.3, 700., 269.])
    temps = T([22.2, 293.4826032991708 - 273.15, 14.6, 12., 9.4, 7.,
               -38.]) + 273.15
    dews = T([19., 284.72955521512614 - 273.15, -11.2, -10.8, -10.4, -10.,
              -53.2]) + 273.15
    res, _, _ = parcels.most_unstable_cape_cin(levels, temps, dews, **MP)
    assert_almost_equal(f(res['cape']), 75.0535446, 2)
    assert_almost_equal(f(res['cin']), -136.685967, 2)


def test_profile_with_lcl_in_levels():
    levels = T([959., 914.8213254198571, 779.2, 751.3, 724.3, 700., 269.])
    temps = T([22.2, 293.623635704588 - 273.15, 14.6, 12., 9.4, 7.,
               -38.]) + 273.15
    dews = T([19., 285.289973457705 - 273.15, -11.2, -10.8, -10.4, -10.,
              -53.2]) + 273.15
    res, _, _ = parcels.most_unstable_cape_cin(levels, temps, dews, **ORACLE)
    assert_almost_equal(f(res['cape']), 230.1982, 2)
    # cin at 1 decimal, as test_golden_metpy.py (the fixture embeds the
    # reference's own LCL pressure as a level, one ulp from ours).
    assert_almost_equal(f(res['cin']), -58.0673, 1)


def _nan_sounding():
    nan = np.nan
    levels = T([1001, 1000, 997, 977.9, 977, 957, 937.8, 925, 906, 899.3, 887,
                862.5, 854, 850, 800, 793.9, 785, 777, 771, 762, 731.8, 726,
                703, 700, 655, 630, 621.2, 602, 570.7, 548, 546.8, 539, 513,
                511, 485, 481, 468, 448, 439, 424, 420, 412.])
    temps = T([-22.5, -22.7, -23.1, nan, -24.5, -25.1, nan, -24.5, -23.9,
               nan, -24.7, nan, -21.3, -21.3, -22.7, nan, -20.7, -16.3,
               -15.5, nan, nan, -15.3, nan, -17.3, -20.9, -22.5, nan, -25.5,
               nan, -31.5, nan, -31.5, -34.1, -34.3, -37.3, -37.7, -39.5,
               -42.1, -43.1, -45.1, -45.7, -46.7]) + 273.15
    dews = T([-25.1, -26.1, -26.8, nan, -27.3, -28.2, nan, -27.2, -26.6, nan,
              -27.4, nan, -23.5, -23.5, -25.1, nan, -22.9, -17.8, -16.6, nan,
              nan, -16.4, nan, -18.5, -21, -23.7, nan, -28.3, nan, -32.6, nan,
              -33.8, -35, -35.1, -38.1, -40, -43.3, -44.6, -46.4, -47, -49.2,
              -50.7]) + 273.15
    return levels, temps, dews


def test_profile_with_nans_mp():
    levels, temps, dews = _nan_sounding()
    res_base = _cape_cin_from_plain_profile(levels, temps, dews)
    prof = profile.parcel_profile(levels, levels[0], temps[0], dews[0],
                                  **ORACLE)
    prof['environment_temperature'] = temps
    lfc = run_lfc_el(prof)
    res_surf, _ = cape.surface_based_cape_cin(levels, temps, dews, **MP)
    res_mu, _, _ = parcels.most_unstable_cape_cin(levels, temps, dews, **MP)
    assert np.isnan(f(lfc['lfc_pressure']))
    for res in (res_base, res_surf, res_mu):
        assert_almost_equal(f(res['cape']), 0, 0)
        assert_almost_equal(f(res['cin']), 0, 0)


def test_profile_with_nans():
    levels, temps, dews = _nan_sounding()
    res_surf, _ = cape.surface_based_cape_cin(levels, temps, dews, **ORACLE)
    res_mu, _, _ = parcels.most_unstable_cape_cin(levels, temps, dews,
                                                  **ORACLE)
    for res in (res_surf, res_mu):
        assert_almost_equal(f(res['cape']), 0, 0)
        assert_almost_equal(f(res['cin']), 0, 0)


def test_mixed_parcel():
    levels, temps, dews = _basic_cape_sounding()
    mixed = parcels.mixed_parcel(levels, temps, dews, depth=250.0)
    assert_almost_equal(f(mixed['pressure']), 959., 6)
    assert_almost_equal(f(mixed['temperature']), 28.7401463 + 273.15, 6)
    assert_almost_equal(f(mixed['dewpoint']), 7.1534658 + 273.15, 6)


def test_mixed_layer():
    levels, temps, _ = _basic_cape_sounding()
    mixed = parcels.mixed_layer({'pressure': levels, 'temperature': temps},
                                depth=250.0)
    assert_almost_equal(f(mixed['temperature']), 16.4024930 + 273.15, 6)


def test_mixed_layer_interior_nan_bridges_gaps():
    p = np.array([900.0, np.nan, 880.0, 870.0, 850.0])
    v = p / 100.0
    depth = 40.0
    frac = (np.log(860.0) - np.log(870.0)) / (np.log(850.0) - np.log(870.0))
    f_top = 8.7 + (8.5 - 8.7) * frac
    expect = (0.5 * (9.0 + 8.8) * 20.0 + 0.5 * (8.8 + 8.7) * 10.0 +
              0.5 * (8.7 + f_top) * 10.0) / depth
    mixed = parcels.mixed_layer({'pressure': T(p), 'v': T(v)}, depth=depth)
    assert_almost_equal(f(mixed['v']), expect, 10)


def test_mixed_layer_value_nan_at_valid_pressure_bridges_per_variable():
    p = np.array([900.0, 890.0, 880.0, 870.0, 850.0])
    v = np.array([9.0, np.nan, 8.8, 8.7, 8.5])
    w = p / 100.0
    depth = 40.0
    frac = (np.log(860.0) - np.log(870.0)) / (np.log(850.0) - np.log(870.0))
    f_top = 8.7 + (8.5 - 8.7) * frac
    expect_v = (0.5 * (9.0 + 8.8) * 20.0 + 0.5 * (8.8 + 8.7) * 10.0 +
                0.5 * (8.7 + f_top) * 10.0) / depth
    expect_w = (0.5 * (9.0 + 8.9) * 10.0 + 0.5 * (8.9 + 8.8) * 10.0 +
                0.5 * (8.8 + 8.7) * 10.0 + 0.5 * (8.7 + f_top) * 10.0) / depth
    mixed = parcels.mixed_layer({'pressure': T(p), 'v': T(v), 'w': T(w)},
                                depth=depth)
    assert_almost_equal(f(mixed['v']), expect_v, 10)
    assert_almost_equal(f(mixed['w']), expect_w, 10)


def test_mixed_layer_bottom_value_nan_divides_by_observed_span():
    p = T([1000.0, 950.0, 900.0, 850.0, 800.0])
    v = T([np.nan, 10.0, 20.0, 30.0, 40.0])
    expect = (0.5 * (10.0 + 20.0) * 50.0) / 50.0
    mixed = parcels.mixed_layer({'pressure': p, 'v': v}, depth=100.0)
    assert_almost_equal(f(mixed['v']), expect, 10)
    shared = parcels.mixed_layer({'pressure': p, 'v': v}, depth=100.0,
                                 valid=ops.notnan(v))
    assert_almost_equal(f(shared['v']), expect, 10)


def test_mixed_layer_single_valid_level_is_nan():
    mixed = parcels.mixed_layer({'pressure': T([1000.0, 950.0]),
                                 'v': T([np.nan, 10.0])}, depth=100.0)
    assert np.isnan(f(mixed['v']))


def test_mixed_layer_cape_cin():
    res, _, _ = parcels.mixed_layer_cape_cin(
        *(T(x) for x in multiple_intersections()), **MP)
    assert_almost_equal(f(res['cape']), 1096.7461, 2)
    assert_almost_equal(f(res['cin']), -20.6727, 2)


# --------------------------------------------------------------- diagnostics

def test_lifted_index():
    pressure = T([1014., 1000., 997., 981.2, 947.4, 925., 914.9, 911., 902.,
                  883., 850., 822.3, 816., 807., 793.2, 770., 765.1, 753.,
                  737.5, 737., 713., 700., 688., 685., 680., 666., 659.8,
                  653., 643., 634., 615., 611.8, 566.2, 516., 500., 487.,
                  484.2, 481., 475., 460., 400.])
    temperature = T([24.2, 24.2, 24., 23.1, 21., 19.6, 18.7, 18.4, 19.2,
                     19.4, 17.2, 15.3, 14.8, 14.4, 13.4, 11.6, 11.1, 10.,
                     8.8, 8.8, 8.2, 7., 5.6, 5.6, 5.6, 4.4, 3.8, 3.2, 3.,
                     3.2, 1.8, 1.5, -3.4, -9.3, -11.3, -13.1, -13.1, -13.1,
                     -13.7, -15.1, -23.5]) + 273.15
    dewpoint = T([23.2, 23.1, 22.8, 22., 20.2, 19., 17.6, 17., 16.8, 15.5,
                  14., 11.7, 11.2, 8.4, 7., 4.6, 5., 6., 4.2, 4.1, -1.8, -2.,
                  -1.4, -0.4, -3.4, -5.6, -4.3, -2.8, -7., -25.8, -31.2,
                  -31.4, -34.1, -37.3, -32.3, -34.1, -37.3, -41.1, -37.7,
                  -58.1, -57.5]) + 273.15
    prof = profile.parcel_profile(pressure, pressure[0], temperature[0],
                                  dewpoint[0], **ORACLE)
    prof['environment_temperature'] = temperature
    li = diagnostics.lifted_index(prof)
    assert_almost_equal(f(li['lifted_index']), -7.9176350, 2)


def test_wet_bulb_temperature():
    val = diagnostics.wet_bulb_temperature(T([1000.]), T([25 + 273.15]),
                                           T([15 + 273.15]), **ORACLE)
    assert_almost_equal(f(val), 18.3432116 + 273.15, 5)


def test_wet_bulb_temperature_saturated():
    val = diagnostics.wet_bulb_temperature(T([850.]), T([17.6 + 273.15]),
                                           T([17.6 + 273.15]), **ORACLE)
    assert_almost_equal(f(val), 17.6 + 273.15, 7)


def test_wet_bulb_temperature_1d():
    val = diagnostics.wet_bulb_temperature(
        T([1013., 1000., 990.]), T([25., 20., 15.]) + 273.15,
        T([20., 15., 10.]) + 273.15, **ORACLE)
    assert_array_almost_equal(arr(val),
                              np.array([21.44487, 16.73673, 12.06554])
                              + 273.15, 5)


def test_el_temperature_uses_above_first_crossing_set():
    """The EL temperature is matched against the above-first crossing set
    its pressure comes from: a gap-0 decreasing crossing at the same
    pressure (same_first False) must not take over the EL temperature."""
    nan = np.nan
    p = T([900., 700., 500., 300.])
    pt = T([300., 281., 250., 220.])
    t = T([295., 281., 252., 230.])
    ints = {k: ops.safe_log(T(v)) if k.endswith('_x') else T(v)
            for k, v in {'all_x': [700., 500., nan],
                         'all_y': [999., 251., nan],
                         'increasing_x': [nan, nan, nan],
                         'increasing_y': [nan, nan, nan],
                         'decreasing_x': [500., 500., nan],
                         'decreasing_y': [999., 251., nan]}.items()}
    lcl_p = T(850.)
    sol = cape.lfc_el(p, pt, t, lcl_p, T(295.), intersections=ints,
                      intersections_in_log=True)
    assert_almost_equal(f(sol['el_pressure']), 500.0, 6)
    assert_almost_equal(f(sol['el_temperature']), 251.0, 6)
