"""Reference-named parity tests, through the port.

The port's counterpart of ``tests/test_reference_names.py``: every test
carries the exact name of a reference test, so the reference's test list
maps onto the port's surfaces too, on ``device='cpu'``.

* ``test_moist_lapse*``: the reference runs these against its lookup-table
  consumer at a loosened 2-decimal tolerance; here against the port's
  default (spectral) consumer, on the JAX package's coefficients (which
  ``test_torch_adiabat.py`` holds equal to the port's own build; building
  them again here on the CPU would take minutes).
* ``test_most_unstable_cape_cin``: dead code in the reference; here it runs
  against the MetPy truth values it quotes, 2 decimals, with the exact
  integrator as the lifting backend.
* ``test_insert_level``: the reference's 2-column duplicate-pressure case.

Attribution: the truth constants (expected values, soundings, tolerances)
derive from MetPy's test suite (Copyright 2008-2023 MetPy Developers, BSD
3-Clause) via the reference's modules/unit_tests.py; see the repository
NOTICE file.  The test code itself is freshly written.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_almost_equal, assert_array_almost_equal

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu_torch import AdiabatTables, adiabat, api, ops
from xarray_parcel_tpu_torch import xarray_api


def tensor(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.fixture(scope='module')
def tables():
    return AdiabatTables.from_numpy(
        np.asarray(jad.load_moist_adiabat_lookups().coeffs), 'cpu',
        torch.float64)


def test_moist_lapse(tables):
    levels = tensor([1000., 800., 600., 500., 400.])
    temp = api.moist_lapse(levels, 293.0, tables=tables)
    assert_array_almost_equal(temp.numpy(),
                              [293, 284.64, 272.81, 264.42, 252.91], 2)


def test_moist_lapse_ref_pres(tables):
    levels = tensor([1050., 800., 600., 500., 400.])
    temp = api.moist_lapse(levels, 293.0, 1000.0, tables=tables)
    assert_array_almost_equal(temp.numpy(),
                              [294.76, 284.64, 272.81, 264.42, 252.91], 2)


def test_moist_lapse_scalar(tables):
    temp = api.moist_lapse(tensor([800.]), 293.0, 1000.0, tables=tables)
    assert_array_almost_equal(temp.numpy(), [284.64], 2)


def test_moist_lapse_uniform(tables):
    temp = api.moist_lapse(tensor([900., 900., 900.]), 293.15, tables=tables)
    assert_array_almost_equal(temp.numpy(), [293.15] * 3, 2)


def test_most_unstable_cape_cin():
    levels = tensor([1000., 959., 867.9, 850., 825., 800.])
    temps = tensor([18.2, 22.2, 17.4, 10., 0., 15.]) + 273.15
    dews = tensor([19., 19., 14.3, 0., -10., 0.]) + 273.15
    res, _, _ = api.most_unstable_cape_cin(
        levels, temps, dews, virtual_temperature_correction=False,
        lcl_interp='linear', moist_lapse=adiabat.moist_lapse_integrate)
    assert_almost_equal(res['cape'].item(), 157.11404, 2)
    assert_almost_equal(res['cin'].item(), -31.8406578, 2)


def test_insert_level():
    fields = {'pressure': tensor([[1000., 900., 800., 700.],
                                  [1000., 900., 800., 700.]]),
              'temperature': torch.ones((2, 4), dtype=torch.float64)}
    level = {'pressure': tensor([1000., 600.]),
             'temperature': tensor([1.5, 2.])}
    res = ops.insert_level(fields, level)
    np.testing.assert_array_equal(
        res['pressure'].numpy(),
        [[1000., 1000., 900., 800., 700.],
         [1000., 900., 800., 700., 600.]])
    np.testing.assert_array_equal(
        res['temperature'].numpy(),
        [[1., 1.5, 1., 1., 1.],
         [1., 1., 1., 1., 2.]])


REFERENCE_DEFS = """interp1d_numba load_moist_adiabat_lookups
    lookup_tables_loaded get_layer most_unstable_parcel mixed_layer
    trapz bound_pressure mixed_parcel dry_lapse moist_adiabat_tables
    round_to wet_bulb_temperature_fast wet_bulb_temperature
    moist_adiabat_lookup moist_lapse lcl mixing_ratio parcel_profile
    virtual_temperature parcel_profile_with_lcl add_lcl_to_profile
    insert_level find_intersections lfc_el trap_around_zeros
    cape_cin_base cape_cin surface_based_cape_cin
    from_most_unstable_parcel most_unstable_cape_cin mix_layer
    mixed_layer_cape_cin shift_out_nans lifted_index linear_interp
    log_interp deep_convective_index min_conv_properties
    conv_properties lapse_rate freezing_level_height
    melting_level_height isobar_temperature wind_shear
    significant_hail_parameter valid_data storm_proxies""".split()


def test_every_reference_def_resolves():
    """Every top-level def of the reference's parcel_functions.py resolves
    under its own name on both of the port's user surfaces (the def list
    is frozen here, as in the JAX package's test)."""
    assert len(REFERENCE_DEFS) == 48
    for name in REFERENCE_DEFS:
        assert callable(getattr(api, name, None)), f'api.{name} missing'
        assert name in api.__all__, f'api.__all__ lacks {name}'
        assert callable(getattr(xarray_api, name, None)), \
            f'xarray_api.{name} missing'

