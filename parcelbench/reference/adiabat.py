"""The reference's moist adiabats: RK4 integration of the pseudoadiabat,
worked out per parcel, with no table.

The program evaluates a precomputed family of 14,300 pseudoadiabats
(starting at 1100 hPa on a 0.01 K grid from 173 K) as Chebyshev series.
The reference integrates dT/dln p = p * Gamma_m(p, T) along each parcel's
own curve instead, and keeps the family's envelope as the program's
semantics state it: a parcel whose curve starts outside the family, or a
level outside 1100-2.5 hPa, gives NaN.
"""

import math

import torch

from .ops.safe import notnan, tensor_like
from .thermo import moist_lapse_rate

P_TOP = 1100.0          # hPa, start of every curve of the program's family
P_BOT = 2.5             # hPa, lowest pressure of the family
T_MIN = 173.0           # K, coldest curve start at P_TOP
CURVE_SPACING = 0.01    # K between consecutive curves
N_CURVES = 14300
LEVEL_SUBSTEPS = 8      # RK4 steps per level walked
START_SUBSTEPS = 24     # RK4 steps from the parcel back to P_TOP


def rk4_step(logp, dlogp, t):
    """One RK4 step of dT/dlnp = p * moist_lapse_rate(p, T)."""
    def f(lp, tt):
        p = torch.exp(lp)
        return p * moist_lapse_rate(p, tt)

    k1 = f(logp, t)
    k2 = f(logp + dlogp / 2, t + dlogp * k1 / 2)
    k3 = f(logp + dlogp / 2, t + dlogp * k2 / 2)
    k4 = f(logp + dlogp, t + dlogp * k3)
    return t + (dlogp / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def integrate_between(t0, logp0, logp1, n_substeps):
    """T integrated from log-pressure ``logp0`` to ``logp1`` in
    ``n_substeps`` fixed RK4 steps."""
    h = (logp1 - logp0) / n_substeps
    t = t0
    for i in range(n_substeps):
        t = rk4_step(logp0 + i * h, h, t)
    return t


def in_family(parcel_pressure, parcel_temperature):
    """Whether the pseudoadiabat through each parcel state starts, at
    1100 hPa, within one curve spacing of the program's family."""
    valid = notnan(parcel_pressure) & notnan(parcel_temperature) & (
        parcel_pressure > 0)
    lp0 = torch.log(torch.where(valid, parcel_pressure, P_TOP))
    t0 = torch.where(valid, parcel_temperature, 273.15)
    top = torch.full_like(lp0, math.log(P_TOP))
    t_start = integrate_between(t0, lp0, top, START_SUBSTEPS)
    fidx = (t_start - T_MIN) / CURVE_SPACING
    return valid & (fidx >= -1.0) & (fidx <= N_CURVES)


def moist_lapse(pressure, parcel_temperature, parcel_pressure=None,
                tables=None, pointwise=False):
    """Temperature at the levels ``pressure`` (..., L) of parcels lifted
    moist-adiabatically from their (...) state, walking the levels in order
    along each parcel's own curve.  A NaN level gives NaN and is skipped.
    ``tables`` is accepted and ignored (the profile code passes it);
    ``pointwise`` is not supported: the reference lifts whole columns."""
    if pointwise:
        raise ValueError('the reference lifts whole columns only')
    if parcel_pressure is None:
        parcel_pressure = pressure[..., 0]
    t0 = tensor_like(parcel_temperature, pressure).to(pressure.dtype)
    p0 = tensor_like(parcel_pressure, pressure).to(pressure.dtype)
    batch = torch.broadcast_shapes(t0.shape, p0.shape, pressure.shape[:-1])
    t0, p0 = t0.expand(batch), p0.expand(batch)
    levels = pressure.expand(batch + pressure.shape[-1:])

    start_valid = in_family(p0, t0)
    lp_cur = torch.log(torch.where(start_valid, p0, P_TOP))
    t_cur = torch.where(start_valid, t0, 273.15)
    outs = []
    for k in range(levels.shape[-1]):
        p_k = levels[..., k]
        valid = notnan(p_k) & (p_k > 0)
        lp_new = torch.where(valid, torch.log(torch.where(valid, p_k, 1.0)),
                             lp_cur)
        t_cur = integrate_between(t_cur, lp_cur, lp_new, LEVEL_SUBSTEPS)
        lp_cur = lp_new
        ok = valid & (p_k >= P_BOT) & (p_k <= P_TOP)
        outs.append(torch.where(ok, t_cur, torch.nan))
    out = torch.stack(outs, -1)
    return torch.where(start_valid[..., None], out, torch.nan)
