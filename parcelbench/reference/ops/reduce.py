"""NaN-aware masked reductions along the level axis (the last axis).

xarray's skip-NaN contract: all-NaN (or empty-selection) max/min/mean give
NaN, an empty sum gives 0.  ``where`` is an extra boolean selection, the
analogue of ``DataArray.where(cond)`` before the reduction.  Inputs are
finite or NaN (a valid ``±inf`` would read as "nothing selected").
"""

import torch

from .safe import notnan


def _mask(x, where):
    m = notnan(x)
    return m if where is None else m & where


def nanmax(x, where=None, dim=-1):
    """Max skipping NaN (and ``~where``); NaN where nothing is selected."""
    r = torch.where(_mask(x, where), x, -torch.inf).amax(dim)
    return torch.where(r == -torch.inf, torch.nan, r)


def nanmin(x, where=None, dim=-1):
    """Min skipping NaN (and ``~where``); NaN where nothing is selected."""
    r = torch.where(_mask(x, where), x, torch.inf).amin(dim)
    return torch.where(r == torch.inf, torch.nan, r)


def nansum(x, where=None, dim=-1):
    """Sum skipping NaN (and ``~where``); 0 where nothing is selected."""
    return torch.where(_mask(x, where), x, 0.0).sum(dim)


def nanmean(x, where=None, dim=-1):
    """Mean skipping NaN (and ``~where``); NaN where nothing is selected."""
    m = _mask(x, where)
    s = torch.where(m, x, 0.0).sum(dim)
    n = m.sum(dim)
    return torch.where(n > 0, s / n.clamp(min=1), torch.nan)
