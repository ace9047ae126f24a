"""Duplicate-aware single-target vertical interpolation (level axis last).

Frozen copy of the program's ``ops.interp``: anchors are the closest coordinate
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
