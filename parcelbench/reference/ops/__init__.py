"""Vertical-column tensor ops: fixed-shape, NaN-aware, level axis last."""

from .reduce import nanmax, nanmin, nansum, nanmean
from .safe import notnan, safe_log, safe_exp, nan_sign, tensor_like
from .interp import interp_many
from .intersect import find_intersections
from .integrate import gap_areas, select_areas, trap_around_zeros
from .levels import insert_level, bound_pressure, get_layer, first_valid_index

__all__ = [
    'nanmax', 'nanmin', 'nansum', 'nanmean',
    'notnan', 'safe_log', 'safe_exp', 'nan_sign', 'tensor_like',
    'interp_many', 'find_intersections', 'gap_areas', 'select_areas',
    'trap_around_zeros', 'insert_level', 'bound_pressure', 'get_layer',
    'first_valid_index',
]
