"""Lifted-parcel temperature profiles (dry below the LCL, moist above).

Frozen copy of the program's ``profile``: fixed-shape columns with the LCL
spliced in as an extra level by ``insert_level``, the virtual-temperature
track computed alongside.  Functions take and return dicts of tensors
(batch dims leading, level axis last) keyed like the reference's Dataset
variables.  NaN levels give NaN outputs but never enter the arithmetic:
every track is computed on safe finite dummies and the NaN pattern applied
after, so reverse-mode gradients stay finite.
"""

import torch

from . import adiabat, thermo
from .lcl import lcl
from .ops import insert_level, interp_many, notnan, tensor_like


def parcel_profile(pressure, parcel_pressure, parcel_temperature,
                   parcel_dewpoint, tables=None, moist_lapse=None):
    """Temperature and virtual temperature of a parcel lifted to
    ``pressure`` (…, L) from its (…) state.

    Returns a dict with ``pressure``, ``temperature``,
    ``virtual_temperature``, ``lcl_pressure``, ``lcl_temperature`` and
    ``lcl_virtual_temperature``.  ``moist_lapse`` is the lifting backend
    (default :func:`adiabat.moist_lapse`; :func:`adiabat.moist_lapse_integrate`
    is the exact-ODE oracle).
    """
    ml = moist_lapse or adiabat.moist_lapse
    pp = tensor_like(parcel_pressure, pressure)
    pt = tensor_like(parcel_temperature, pressure)
    pd = tensor_like(parcel_dewpoint, pressure)
    # A shared level vector with batched parcels is legal: carry the full
    # (batch, L) pressure so every track has one shape.
    batch = torch.broadcast_shapes(pp.shape, pt.shape, pd.shape,
                                   pressure.shape[:-1])
    pressure = pressure.expand(batch + pressure.shape[-1:])

    out = {'pressure': pressure}
    out.update(lcl(pp, pt, pd))
    lcl_p = out['lcl_pressure']

    validp = notnan(pressure)
    safe_p = torch.where(validp, pressure, 500.0)

    below_lcl = thermo.dry_lapse(safe_p, pt[..., None], pp[..., None])
    above_lcl = ml(safe_p, out['lcl_temperature'], lcl_p, tables=tables,
                   pointwise=False)
    above_lcl = torch.where(validp, above_lcl, torch.nan)

    lcl_pb = lcl_p[..., None]
    temp = torch.where(pressure >= lcl_pb, below_lcl, above_lcl)
    temp = torch.where(validp, temp, torch.nan)
    out['temperature'] = temp

    # Mixing ratio: the parcel's (constant) below the LCL, saturated above.
    parcel_w = thermo.mixing_ratio(pt, pd, pp)
    validt = notnan(temp)
    safe_t = torch.where(validt, temp, 273.15)
    sat_w = thermo.saturation_mixing_ratio(safe_p, safe_t)
    w = torch.where(pressure <= lcl_pb, sat_w, parcel_w[..., None])
    vt = thermo.virtual_temperature(safe_t, w)
    out['virtual_temperature'] = torch.where(validt, vt, torch.nan)
    return out


def add_lcl_to_profile(profile, environment=None, interpolator='log'):
    """Splice the LCL level into a profile (and optionally the
    environment).

    The environment's other variables are interpolated at the LCL pressure
    (log-p by default, ``'linear'`` as MetPy), its virtual temperature at
    the LCL recomputed from the interpolated temperature and dewpoint, and
    both gain one level; environment variables come back as
    ``environment_<name>``.
    """
    if interpolator not in ('linear', 'log'):
        raise ValueError(f'interpolator must be linear or log, not '
                         f'{interpolator!r}')
    level = {'pressure': profile['lcl_pressure'],
             'temperature': profile['lcl_temperature'],
             'virtual_temperature': profile['lcl_virtual_temperature']}
    out = insert_level(
        {k: profile[k] for k in ('pressure', 'temperature',
                                 'virtual_temperature')}, level)
    for k in ('lcl_pressure', 'lcl_temperature', 'lcl_virtual_temperature'):
        out[k] = profile[k]

    if environment is not None:
        skip = ('pressure', 'virtual_temperature') \
            if 'virtual_temperature' in environment else ('pressure',)
        interp_level = interp_many(
            {k: v for k, v in environment.items() if k not in skip},
            environment['pressure'], level['pressure'],
            log=interpolator == 'log')
        interp_level['pressure'] = level['pressure']
        if 'virtual_temperature' in environment:
            mix = thermo.mixing_ratio(interp_level['temperature'],
                                      interp_level['dewpoint'],
                                      interp_level['pressure'])
            interp_level['virtual_temperature'] = thermo.virtual_temperature(
                interp_level['temperature'], mix)
        new_env = insert_level(environment, interp_level)
        for k in environment:
            if k != 'pressure':
                out['environment_' + k] = new_env[k]
    return out


def parcel_profile_with_lcl(pressure, temperature, dewpoint, parcel_pressure,
                            parcel_temperature, parcel_dewpoint,
                            lcl_interp='log', tables=None, moist_lapse=None):
    """Parcel profile including the LCL level, plus the environment
    temperature, virtual temperature and dewpoint tracks spliced at the
    LCL; every output column has L+1 levels."""
    profile = parcel_profile(pressure, parcel_pressure, parcel_temperature,
                             parcel_dewpoint, tables=tables,
                             moist_lapse=moist_lapse)
    valid = notnan(temperature) & notnan(dewpoint) & notnan(pressure)
    safe_t = torch.where(valid, temperature, 273.15)
    safe_td = torch.where(valid, dewpoint, 263.15)
    safe_p = torch.where(valid, pressure, 500.0)
    mix = thermo.mixing_ratio(safe_t, safe_td, safe_p)
    env_vt = torch.where(valid, thermo.virtual_temperature(safe_t, mix),
                         torch.nan)
    shape = profile['pressure'].shape
    environment = {
        'temperature': temperature.expand(shape),
        'virtual_temperature': env_vt.expand(shape),
        'dewpoint': dewpoint.expand(shape),
        'pressure': profile['pressure'],
    }
    return add_lcl_to_profile(profile, environment=environment,
                              interpolator=lcl_interp)
