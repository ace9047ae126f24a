"""Lifting condensation level: vectorised fixed-point solver.

Frozen copy of the program's ``lcl``.  With the parcel's mixing ratio w fixed,
p_{k+1} = p0 * (Td(e(p_k, w)) / T0) ** (1/kappa), iterated on safe finite
dummies; the NaN pattern is applied once at the end.
"""

import torch

from . import constants as c
from . import thermo
from .ops.safe import notnan


def lcl(parcel_pressure, parcel_temperature, parcel_dewpoint, iterations=30):
    """LCL pressure [hPa], temperature [K] and virtual temperature [K] of
    parcels (elementwise), as a dict with ``lcl_pressure``,
    ``lcl_temperature`` and ``lcl_virtual_temperature``."""
    p0, t0, td0 = torch.broadcast_tensors(parcel_pressure, parcel_temperature,
                                          parcel_dewpoint)
    valid = notnan(p0) & notnan(t0) & notnan(td0)
    p0 = torch.where(valid, p0, 1000.0)
    t0 = torch.where(valid, t0, 288.0)
    td0 = torch.where(valid, td0, 283.0)

    w = thermo.mixing_ratio_from_partial_pressure(
        thermo.saturation_vapor_pressure(td0), p0)
    lcl_p = p0
    for _ in range(iterations):
        td = thermo.dewpoint(thermo.vapor_pressure(lcl_p, w))
        lcl_p = p0 * (td / t0) ** (1.0 / c.kappa)
    lcl_t = thermo.dewpoint(thermo.vapor_pressure(lcl_p, w))

    # Virtual temperature at the LCL (temperature == dewpoint there).
    lcl_vt = thermo.virtual_temperature(
        lcl_t, thermo.mixing_ratio(lcl_t, lcl_t, lcl_p))
    return {
        'lcl_pressure': torch.where(valid, lcl_p, torch.nan),
        'lcl_temperature': torch.where(valid, lcl_t, torch.nan),
        'lcl_virtual_temperature': torch.where(valid, lcl_vt, torch.nan),
    }
