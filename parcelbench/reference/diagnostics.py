"""Scalar convection diagnostics, plain torch.

Frozen copy of the program's ``diagnostics`` functions that the
full diagnostics set reads: lifted index, deep convective index, 700-500
hPa lapse rate, freezing level, the melting level of the Knox wet bulb and
bulk wind shear.  The program computes the same quantities in its CUDA
tail kernel; none of that is here.
"""

import torch

from . import thermo
from .ops import find_intersections, interp_many, nanmin


def lifted_index(profile):
    """Galway (1956) lifted index: environment minus parcel temperature at
    500 hPa, from a profile dict (``pressure``, ``temperature``,
    ``environment_temperature``)."""
    env, parcel = interp_many(
        (profile['environment_temperature'], profile['temperature']),
        profile['pressure'], 500.0, log=True)
    return env - parcel


def deep_convective_index(t850, td850, lifted_index):
    """Kunz (2009) DCI: T850C + Td850C - LI."""
    return (t850 - 273.15) + (td850 - 273.15) - lifted_index


def lapse_rate(pressure, temperature, height, from_pressure=700.0,
               to_pressure=500.0):
    """Environmental lapse rate [K/km] between two pressure levels, and
    the temperature at ``to_pressure``."""
    t_from, h_from = interp_many((temperature, height), pressure,
                                 from_pressure, log=True)
    t_to, h_to = interp_many((temperature, height), pressure, to_pressure,
                             log=True)
    return (t_to - t_from) / ((h_to - h_from) / 1000.0), t_to


def freezing_level_height(temperature, height):
    """Height [m] of the lowest 0 C crossing of the temperature."""
    zeros = torch.full_like(temperature, 273.15)
    ints = find_intersections(height, temperature, zeros)
    return nanmin(ints['all_x'])


def melting_level_height(temperature, dewpoint, height):
    """Height of the 0 C wet-bulb isotherm, the wet bulb by the Knox
    one-third rule."""
    wb = thermo.wet_bulb_temperature_fast(temperature, dewpoint)
    return freezing_level_height(wb, height)


def wind_shear(surface_wind_u, surface_wind_v, wind_u, wind_v, height,
               shear_height=6000.0):
    """Bulk shear between the surface wind and the wind interpolated at
    ``shear_height``: shear_u, shear_v, shear_magnitude, positive_shear."""
    high_u, high_v = interp_many((wind_u, wind_v), height, shear_height)
    shear_u = high_u - surface_wind_u
    shear_v = high_v - surface_wind_v
    high_mag = torch.sqrt(high_u ** 2 + high_v ** 2)
    surf_mag = torch.sqrt(surface_wind_u ** 2 + surface_wind_v ** 2)
    return {
        'shear_u': shear_u,
        'shear_v': shear_v,
        'shear_magnitude': torch.sqrt(shear_u ** 2 + shear_v ** 2),
        'positive_shear': high_mag > surf_mag,
    }
