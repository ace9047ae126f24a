"""Fixed-shape vertical level manipulation (level axis last).

Frozen copy of the program's ``ops.levels``: ``insert_level`` splices a
per-column level (the LCL) into pressure-sorted columns of L levels,
giving L+1 slots.  NaN is the missing-value sentinel and pressure the sort
coordinate (decreasing with level, NaNs trailing or leading).
"""

import torch

from .interp import interp_many
from .reduce import nanmax, nanmin
from .safe import notnan


def _broadcast_fields(fields):
    return dict(zip(fields, torch.broadcast_tensors(*fields.values())))


def first_valid_index(p):
    """Index of the first non-NaN level (0 for an all-NaN column): the
    length of a masked sub-parcel column's leading-NaN prefix."""
    return torch.argmax(notnan(p).to(torch.uint8), dim=-1)


def insert_level(fields, level, coord='pressure', lead=None):
    """Insert a per-column level into pressure-sorted profiles.

    ``fields``: dict of (…, L) tensors including ``coord``; ``level``: dict
    of (…) values for the same keys.  Returns a dict with the keys of
    ``level`` and L+1 levels:
      * the new level goes one past the LAST valid level whose coordinate
        is >= its own (a duplicate coordinate is inserted above the
        existing level), and never below ``lead``;
      * slots sourced from NaN-coordinate levels are NaN in every key;
      * a NaN insertion coordinate floods the column with the level's
        values.
    ``lead``: per-column leading-NaN count (default: computed).
    """
    fields = _broadcast_fields({k: fields[k] for k in level})
    p = fields[coord]
    pl = level[coord]
    L = p.shape[-1]
    if lead is None:
        lead = first_valid_index(p)
    lead = lead.to(torch.int64)

    p_filled = torch.where(torch.isnan(p), -torch.inf, p)
    ii = torch.arange(1, L + 1, device=p.device)
    idx = torch.where(p_filled >= pl[..., None], ii, 0).amax(-1)
    idx = torch.maximum(idx, lead)[..., None]              # (…, 1) in [0, L]

    j = torch.arange(L + 1, device=p.device)
    below = j < idx
    at = j == idx
    nan = torch.full(p.shape[:-1] + (1,), torch.nan, dtype=p.dtype,
                     device=p.device)
    out = {}
    for k in level:
        v = fields[k]
        v_pad = torch.cat([v, nan], -1)                    # v[j]
        v_prev = torch.cat([nan, v], -1)                   # v[j-1]
        out[k] = torch.where(below, v_pad,
                             torch.where(at, level[k][..., None], v_prev))

    slot_nan = torch.isnan(out[coord]) & ~at
    for k in out:
        if k != coord:
            out[k] = torch.where(slot_nan, torch.nan, out[k])

    flood = torch.isnan(pl)[..., None]
    for k in out:
        out[k] = torch.where(flood, level[k][..., None], out[k])
    return out


def bound_pressure(pressure, bound):
    """Closest pressure level to ``bound``; ties take the larger pressure."""
    diffs = torch.abs(pressure - bound[..., None])
    min_diff = nanmin(diffs)
    return nanmax(pressure, where=diffs == min_diff[..., None])


def get_layer(fields, depth=100.0, interpolate=True, coord='pressure'):
    """Surface-based layer of the given pressure depth [hPa]; levels
    outside the layer are NaN-masked.

    With ``interpolate`` the layer top is log-interpolated and inserted as
    a new level (L+1 levels out); otherwise it snaps to the nearest
    existing level (L levels out).
    """
    p = fields[coord]
    bottom = nanmax(p)
    if interpolate:
        top = bottom - depth
        level = interp_many({k: v for k, v in fields.items() if k != coord},
                            p, top, log=True)
        level[coord] = top
        fields = insert_level(fields, level, coord=coord)
    else:
        top = bound_pressure(p, bottom - depth)
        fields = _broadcast_fields(fields)
    pnew = fields[coord]
    mask = (pnew <= bottom[..., None]) & (pnew >= top[..., None])
    return {k: torch.where(mask, v, torch.nan) for k, v in fields.items()}
