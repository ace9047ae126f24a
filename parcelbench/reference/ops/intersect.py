"""Fixed-shape piecewise-linear curve intersections (level axis last).

Frozen copy of the program's ``ops.intersect``: gap k (levels k and k+1) holds
the crossing of that gap, NaN where there is none, giving (…, L-1) outputs.
"""

import torch

from .safe import nan_sign, notnan, safe_exp, safe_log


def find_intersections(x, a, b, log_x=False, log_x_values=None,
                       log_outputs=False):
    """Crossings of curves ``a`` and ``b`` over shared coordinates ``x``.

    Returns a dict of (…, L-1) tensors: ``all_x``/``all_y``,
    ``increasing_x``/``increasing_y`` (``a`` crosses above ``b``) and
    ``decreasing_x``/``decreasing_y``; with ``log_x`` also ``all_logx``.
    A gap whose sign pair holds a NaN counts as a crossing with NaN
    coordinates, as in the reference; the direction is the sign at the
    after point.  ``log_x_values``: precomputed ``log(x)``;
    ``log_outputs``: keep every ``*_x`` output in log space.
    """
    if log_x:
        x = log_x_values if log_x_values is not None else safe_log(x)

    sign = nan_sign(a - b)
    s0, s1 = sign[..., :-1], sign[..., 1:]
    crossing = s0 != s1                     # True for NaN pairs

    x0, x1 = x[..., :-1], x[..., 1:]
    a0, a1 = a[..., :-1], a[..., 1:]
    b0, b1 = b[..., :-1], b[..., 1:]

    delta_y0 = a0 - b0
    delta_y1 = a1 - b1
    finite = (crossing & notnan(delta_y0) & notnan(delta_y1) &
              notnan(x0) & notnan(x1))
    d0 = torch.where(finite, delta_y0, 0.0)
    d1 = torch.where(finite, delta_y1, 1.0)
    xs0 = torch.where(finite, x0, 0.0)
    xs1 = torch.where(finite, x1, 1.0)
    as0 = torch.where(finite & notnan(a0), a0, 0.0)
    as1 = torch.where(finite & notnan(a1), a1, 0.0)
    dy = d1 - d0
    dy = torch.where(finite & (dy != 0), dy, 1.0)
    dx = xs1 - xs0
    dx = torch.where(finite & (dx != 0), dx, 1.0)
    intersect_x = (d1 * xs0 - d0 * xs1) / dy
    intersect_y = ((intersect_x - xs0) / dx) * (as1 - as0) + as0
    # Duplicate-coordinate gaps keep the unguarded algebra's NaN y.
    intersect_y = torch.where(x1 != x0, intersect_y, torch.nan)

    intersect_x = torch.where(finite, intersect_x, torch.nan)
    intersect_y = torch.where(finite & notnan(a0) & notnan(a1),
                              intersect_y, torch.nan)
    out_x = (safe_exp(intersect_x) if log_x and not log_outputs
             else intersect_x)

    sign_change = torch.where(crossing, s1, torch.nan)
    inc = sign_change > 0
    dec = sign_change < 0
    out = {
        'all_x': out_x,
        'all_y': intersect_y,
        'increasing_x': torch.where(inc, out_x, torch.nan),
        'increasing_y': torch.where(inc, intersect_y, torch.nan),
        'decreasing_x': torch.where(dec, out_x, torch.nan),
        'decreasing_y': torch.where(dec, intersect_y, torch.nan),
    }
    if log_x:
        out['all_logx'] = intersect_x
    return out
