"""Reference-compatible API facade.

Port of ``xarray_parcel_tpu.api``: one namespace with the public surface of
the reference's ``parcel_functions`` module, so that a user of the
reference finds every entry point under the same name, operating on
tensors (batch dims leading, level axis last) instead of DataArrays with a
``vert_dim``.  Where the reference returns a Dataset, these return a
dict/FieldSet keyed by the same variable names; ``prefix`` kwargs rename
keys exactly as the reference does.  Functions follow their tensors'
device; ``valid_data`` is a host-side check on numpy arrays.
"""

import numpy as np
import torch

from . import adiabat, native, thermo
from . import ops as _ops
from . import profile as _profile
from ._device import resolve_device
from .adiabat import (AdiabatTables, load_moist_adiabat_lookups, moist_lapse,
                      moist_lapse_integrate, round_to)
from .cape import cape_cin, cape_cin_base, lfc_el
from .cape import surface_based_cape_cin as _sb_cape_cin
from .diagnostics import (deep_convective_index as _dci,
                          freezing_level_height, isobar_temperature,
                          lapse_rate, lifted_index as _lifted_index,
                          melting_level_height, significant_hail_parameter,
                          wet_bulb_temperature, wind_shear)
from .fieldset import FieldSet, annotate, attrs_for
from .lcl import lcl
from .ops import (bound_pressure, compact_left, find_intersections,
                  get_layer, insert_level, interp1d, linear_interp,
                  log_interp, trap_around_zeros, trapz)
from .ops.safe import tensor_like
from .parcels import (from_most_unstable_parcel, mix_layer, mixed_layer,
                      mixed_parcel, most_unstable_parcel)
from .parcels import (mixed_layer_cape_cin as _ml_cape_cin,
                      most_unstable_cape_cin as _mu_cape_cin)
from .pipeline import (conv_properties, conv_properties_fused,
                       min_conv_properties, min_conv_properties_fused,
                       storm_proxies)
from .thermo import (dewpoint_from_specific_humidity, mixing_ratio,
                     virtual_temperature, wet_bulb_temperature_fast)

__all__ = [
    'AdiabatTables', 'FieldSet', 'adiabat', 'add_lcl_to_profile', 'annotate',
    'attrs_for', 'bound_pressure', 'cape_cin', 'cape_cin_base',
    'compact_left', 'conv_properties', 'conv_properties_fused',
    'deep_convective_index', 'dewpoint_from_specific_humidity', 'dry_lapse',
    'find_intersections', 'freezing_level_height',
    'from_most_unstable_parcel', 'get_layer', 'insert_level', 'interp1d',
    'interp1d_numba', 'isobar_temperature', 'lapse_rate', 'lcl', 'lfc_el',
    'lifted_index', 'linear_interp', 'load_moist_adiabat_lookups',
    'log_interp', 'lookup_tables_loaded', 'melting_level_height',
    'min_conv_properties', 'min_conv_properties_fused', 'mix_layer',
    'mixed_layer', 'mixed_layer_cape_cin', 'mixed_parcel', 'mixing_ratio',
    'moist_adiabat_lookup', 'moist_adiabat_tables', 'moist_lapse',
    'moist_lapse_integrate', 'most_unstable_cape_cin',
    'most_unstable_parcel', 'parcel_profile', 'parcel_profile_with_lcl',
    'round_to', 'shift_out_nans', 'significant_hail_parameter',
    'storm_proxies', 'surface_based_cape_cin', 'thermo', 'trap_around_zeros',
    'trapz', 'valid_data', 'virtual_temperature', 'wet_bulb_temperature',
    'wet_bulb_temperature_fast', 'wind_shear']

# The reference's name for the left-compaction primitive.
shift_out_nans = compact_left

# The reference's interp1d_numba (its name advertises a numba
# implementation; the neutral name is kept beside it).
interp1d_numba = interp1d


def moist_adiabat_tables(device=None, dtype=torch.float32):
    """The full tables (coefficients, curves, lookup) built on ``device``
    (None: the GPU): the reference's raw table construction.
    ``load_moist_adiabat_lookups`` is the cached form."""
    return AdiabatTables.build(resolve_device(device), dtype,
                               with_tables=True)


moist_adiabat_lookup = moist_adiabat_tables


def lookup_tables_loaded():
    """True when ``load_moist_adiabat_lookups`` has loaded the default
    tables (the reference's assert guard)."""
    return adiabat._LOADED is not None


def dry_lapse(pressure, parcel_temperature, parcel_pressure=None):
    """Dry adiabat; the parcel pressure defaults to the column maximum
    (skipping NaN, as the reference's xarray ``.max``)."""
    if parcel_pressure is None:
        parcel_pressure = _ops.nanmax(pressure)
    pt = tensor_like(parcel_temperature, pressure)
    pp = tensor_like(parcel_pressure, pressure)
    if pt.dim() < pressure.dim():
        pt = pt[..., None]
    if pp.dim() < pressure.dim():
        pp = pp[..., None]
    return thermo.dry_lapse(pressure, pt, pp)


def _rename(res, prefix):
    if prefix is None:
        return res
    return type(res)({f'{prefix}_{k}': v for k, v in res.items()})


def surface_based_cape_cin(pressure, temperature, dewpoint, prefix=None,
                           **kwargs):
    res, profile = _sb_cape_cin(pressure, temperature, dewpoint, **kwargs)
    return _rename(annotate(res), prefix), annotate(profile)


def most_unstable_cape_cin(pressure, temperature, dewpoint, depth=300.0,
                           prefix=None, **kwargs):
    res, profile, parcel = _mu_cape_cin(pressure, temperature, dewpoint,
                                        depth=depth, **kwargs)
    return (_rename(annotate(res), prefix), annotate(profile),
            annotate(parcel))


def mixed_layer_cape_cin(pressure, temperature, dewpoint, depth=100.0,
                         prefix=None, **kwargs):
    res, profile, parcel = _ml_cape_cin(pressure, temperature, dewpoint,
                                        depth=depth, **kwargs)
    return (_rename(annotate(res), prefix), annotate(profile),
            annotate(parcel))


def lifted_index(profile, prefix=None, description=None):
    res = _rename(_lifted_index(profile), prefix)
    key = f'{prefix}_lifted_index' if prefix else 'lifted_index'
    return annotate(res, {key: description} if description else None)


def deep_convective_index(pressure, temperature, dewpoint, lifted_index,
                          prefix=None, description=None):
    res = _rename(_dci(pressure, temperature, dewpoint, lifted_index),
                  prefix)
    key = f'{prefix}_dci' if prefix else 'dci'
    return annotate(res, {key: description} if description else None)


def parcel_profile(pressure, parcel_pressure, parcel_temperature,
                   parcel_dewpoint, **kwargs):
    return annotate(_profile.parcel_profile(
        pressure, parcel_pressure, parcel_temperature, parcel_dewpoint,
        **kwargs))


def parcel_profile_with_lcl(pressure, temperature, dewpoint, parcel_pressure,
                            parcel_temperature, parcel_dewpoint, **kwargs):
    return annotate(_profile.parcel_profile_with_lcl(
        pressure, temperature, dewpoint, parcel_pressure,
        parcel_temperature, parcel_dewpoint, **kwargs))


def add_lcl_to_profile(profile, environment=None, interpolator='log'):
    return annotate(_profile.add_lcl_to_profile(
        profile, environment=environment, interpolator=interpolator))


def valid_data(dat, strict=True):
    """Validate the reference's input invariant on host data: pressure
    strictly decreasing along the level axis (NaN padding allowed at the
    top).  ``dat``: an array (or tensor) of pressures, or a dict holding
    one under ``'pressure'``.

    Returns the per-column validity mask as a numpy boolean array (one
    entry per column, so ``valid_data(d, strict=False).all()`` is the
    scalar form), and raises ``ValueError`` on any invalid column when
    ``strict``.
    """
    p = dat['pressure'] if isinstance(dat, dict) else dat
    if torch.is_tensor(p):
        p = p.detach().cpu().numpy()
    ok = native.validate_columns(np.asarray(p))
    if strict and not np.all(ok):
        raise ValueError(
            'Pressures must decrease with increasing level number.')
    return ok
