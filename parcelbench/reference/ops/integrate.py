"""Per-gap trapezoid areas and zero-crossing rectangle areas (level axis
last).

Frozen copy of the program's ``ops.integrate``: a column of L levels has L-1
gaps; the CAPE/CIN integrator sums whole-gap trapezoids plus two rectangles
around every buoyancy zero crossing, with a gap mask against double
counting.
"""

import torch

from .intersect import find_intersections
from .safe import notnan, safe_log


def gap_areas(y, x):
    """Per-gap trapezoid areas ``|dx| * mean(y)`` of ``y`` against ``x`` and
    whether both endpoints are non-NaN in both, each (…, L-1).  Areas of
    invalid gaps are computed on zero dummies; the caller's selection
    drops them."""
    y0, y1 = y[..., :-1], y[..., 1:]
    x0, x1 = x[..., :-1], x[..., 1:]
    valid = notnan(y0) & notnan(y1) & notnan(x0) & notnan(x1)
    dx = torch.abs(torch.where(valid, x1 - x0, 0.0))
    means = 0.5 * (torch.where(valid, y0, 0.0) + torch.where(valid, y1, 0.0))
    return dx * means, valid


def select_areas(areas, valid, mask=None, only_positive=False,
                 only_negative=False):
    """Masked sum over a ``gap_areas`` set."""
    if only_positive and only_negative:
        raise ValueError('only_positive and only_negative exclude each other')
    sel = valid if mask is None else valid & mask
    if only_positive:
        sel = sel & (areas > 0)
    if only_negative:
        sel = sel & (areas < 0)
    return torch.where(sel, areas, 0.0).sum(-1)


def trap_around_zeros(x, y, log_x=True, start=0, intersections=None,
                      log_x_values=None):
    """Rectangle areas hugging each zero crossing of ``y`` along ``x``,
    from level ``start`` on.

    ``intersections``: a precomputed crossing set of the same curves
    (``find_intersections(x, a, b, log_x)`` with ``y = a - b``), only with
    ``start=0``; ``log_x_values``: a precomputed ``log(x)``.
    Returns ``(areas, gap_mask)``: ``areas`` holds 'area', 'x', 'dx',
    'x_from' and 'x_to', each (…, 2*(L-start-1)) -- the before-rectangles
    then the after-rectangles, NaN where no crossing, positions in log-x
    space when ``log_x``; ``gap_mask`` (…, L-1) is False for gaps that hold
    a crossing and True for every gap before ``start``.
    """
    if intersections is not None and start:
        raise ValueError('precomputed intersections require start=0')
    x, y = torch.broadcast_tensors(x, y)
    xs, ys = x[..., start:], y[..., start:]
    if log_x:
        xl = (log_x_values[..., start:] if log_x_values is not None
              else safe_log(xs))
    else:
        xl = xs
    ints = (intersections if intersections is not None else
            find_intersections(xs, ys, torch.zeros_like(ys), log_x=log_x,
                               log_x_values=xl if log_x else None))
    if log_x:
        zx = ints.get('all_logx')
        if zx is None:
            zx = safe_log(ints['all_x'])
    else:
        zx = ints['all_x']
    crossing = notnan(ints['all_x'])
    zx_safe = torch.where(crossing & notnan(zx), zx, 0.0)

    def rects(point_x, point_y):
        keep = crossing & notnan(zx) & notnan(point_y) & notnan(point_x)
        px = torch.where(keep, point_x, 0.0)
        dx = px - zx_safe
        y_safe = torch.where(keep, point_y, 0.0)
        area = (y_safe * 0.5) * torch.abs(dx)
        pos = px - dx * 0.5
        return (torch.where(keep, area, torch.nan),
                torch.where(keep, pos, torch.nan),
                torch.where(keep, torch.abs(dx), torch.nan))

    area_b, pos_b, dx_b = rects(xl[..., :-1], ys[..., :-1])
    area_a, pos_a, dx_a = rects(xl[..., 1:], ys[..., 1:])
    pos = torch.cat([pos_b, pos_a], -1)
    dx = torch.cat([dx_b, dx_a], -1)
    areas = {'area': torch.cat([area_b, area_a], -1), 'x': pos, 'dx': dx,
             'x_from': pos - dx * 0.5, 'x_to': pos + dx * 0.5}
    gap_mask = ~crossing
    if start:
        lead = torch.ones(gap_mask.shape[:-1] + (start,), dtype=torch.bool,
                          device=gap_mask.device)
        gap_mask = torch.cat([lead, gap_mask], -1)
    return areas, gap_mask
