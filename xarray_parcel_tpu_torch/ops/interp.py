"""Duplicate-aware single-target vertical interpolation (level axis last).

Port of ``xarray_parcel_tpu.ops.interp``: anchors are the closest coordinate
>= the target and the closest <= it; duplicate anchor coordinates average
their values; equal anchor values pass through unchanged; targets outside
the column give NaN, or with ``extrapolate`` lie on the line through the
two outermost distinct coordinates.
"""

import torch

from .reduce import nanmax, nanmean, nanmin
from .safe import notnan, safe_log


def interp_many(xs, coords, at, extrapolate=False, log=False,
                log_coords=None):
    """Interpolate several (…, L) variables at one per-column target ``at``
    (a tensor of shape (…) or a float), sharing one anchor computation.

    ``xs``: dict or sequence of tensors; the same container type comes back.
    ``extrapolate``: a target outside the column takes the line through
    the two outermost distinct coordinates on its side.
    ``log``: interpolate in log-coordinate space; ``log_coords`` optionally
    supplies the precomputed ``log(coords)``.
    """
    if not torch.is_tensor(at):
        at = torch.tensor(at, dtype=coords.dtype, device=coords.device)
    if log:
        coords = log_coords if log_coords is not None else safe_log(coords)
        at = safe_log(at)
    atb = at[..., None]

    coords_before = nanmin(coords, where=coords >= atb)
    coords_after = nanmax(coords, where=coords <= atb)

    if extrapolate:
        below = torch.isnan(coords_before)
        above = torch.isnan(coords_after)
        # Second largest / second smallest coordinate (duplicates of the
        # extreme one are skipped, as in the reference).
        second_lowest = nanmax(coords,
                               where=coords != nanmax(coords)[..., None])
        second_highest = nanmin(coords,
                                where=coords != nanmin(coords)[..., None])
        coords_before = torch.where(below, coords_after, coords_before)
        coords_after = torch.where(below, second_lowest, coords_after)
        coords_after = torch.where(above, coords_before, coords_after)
        coords_before = torch.where(above, second_highest, coords_before)

    mask_before = coords == coords_before[..., None]
    mask_after = coords == coords_after[..., None]
    span = coords_after - coords_before
    span = torch.where((span != 0) & notnan(span), span, 1.0)
    frac = (at - coords_before) / span

    def one(x):
        x_before = nanmean(x, where=mask_before)
        x_after = nanmean(x, where=mask_after)
        res = x_before + (x_after - x_before) * frac
        return torch.where(x_before == x_after, x_before, res)

    if isinstance(xs, dict):
        return {k: one(v) for k, v in xs.items()}
    return type(xs)(one(v) for v in xs)


def linear_interp(x, coords, at, extrapolate=False):
    """Interpolate ``x`` (…, L) at the per-column target ``at``."""
    return interp_many((x,), coords, at, extrapolate=extrapolate)[0]


def log_interp(x, coords, at, extrapolate=False):
    """``linear_interp`` in log-coordinate space."""
    return interp_many((x,), coords, at, extrapolate=extrapolate,
                       log=True)[0]


def interp1d(at, xp, fp):
    """Per-column linear interpolation with ``np.interp`` semantics.

    ``at``: query points (…, M); ``xp``: monotonically increasing knots
    (…, N); ``fp``: knot values (…, N).  Queries outside the knots clamp to
    the end values; NaN queries give NaN (and never enter the arithmetic).
    """
    batch = torch.broadcast_shapes(at.shape[:-1], xp.shape[:-1],
                                   fp.shape[:-1])
    at = at.expand(batch + at.shape[-1:])
    xp = xp.expand(batch + xp.shape[-1:]).contiguous()
    fp = fp.expand(batch + fp.shape[-1:])
    nan = torch.isnan(at)
    # searchsorted wants ordered queries no more than the knots; a NaN
    # query sorts as the largest value, and is masked at the end.
    idx = torch.searchsorted(xp, at.contiguous(), side='left')
    hi = idx.clamp(1, xp.shape[-1] - 1)
    lo = hi - 1
    x0, x1 = xp.gather(-1, lo), xp.gather(-1, hi)
    f0, f1 = fp.gather(-1, lo), fp.gather(-1, hi)
    safe_at = torch.where(nan, x0, at)
    t = (safe_at - x0) / (x1 - x0)
    out = f0 + t * (f1 - f0)
    out = torch.where(safe_at <= xp[..., :1], fp[..., :1], out)
    out = torch.where(safe_at >= xp[..., -1:], fp[..., -1:], out)
    return torch.where(nan, torch.nan, out)
