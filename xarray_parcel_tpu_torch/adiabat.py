"""Moist (pseudo)adiabat engine: RK4 integrator, spectral coefficients and
the table consumer ``moist_lapse``.

Port of ``xarray_parcel_tpu.adiabat`` without its table builders.  The
curve family is 14,300 pseudoadiabats whose start temperatures at 1100 hPa
lie on a 0.01 K grid.  Each curve is stored as piecewise Chebyshev
coefficients of T(ln p): three segments split at 50 and 230 hPa, 14 terms
each.  A parcel's fractional curve index comes from integrating the ODE
backward to 1100 hPa; the two bracketing coefficient rows are blended into
one row per column, which the CAPE/CIN kernel (and ``moist_lapse``'s
default mode) evaluates at every level.

``build_spectral`` makes the coefficients here, on any device, so the
default path needs no table cache from the JAX package.  ``moist_lapse``'s
table modes read the JAX package's curve and lookup tables, carried across
by ``AdiabatTables.from_numpy``; ``moist_lapse_integrate`` is the exact-ODE
oracle.
"""

import functools

import numpy as np
import torch
from torch import nn

from .ops.safe import notnan, tensor_like
from .thermo import moist_lapse_rate

# Table grid (the reference's moist-adiabat lookup grid).
P_TOP = 1100.0          # hPa, start of every curve (highest pressure)
P_BOT = 2.5             # hPa, lowest pressure
P_STEP = 0.5            # hPa
N_PRES = int(round((P_TOP - P_BOT) / P_STEP)) + 1     # 2196
T_MIN = 173.0           # K
T_MAX_EXCL = 316.0      # K (exclusive, arange semantics)
T_STEP = 0.02           # K
N_TEMP = int(round((T_MAX_EXCL - T_MIN) / T_STEP))    # 7150
N_CURVES = 2 * N_TEMP                                  # 14300 (offsets 0, 0.01)
CURVE_OFFSET = T_STEP / 2.0

# Piecewise Chebyshev representation.
N_SEG = 3
SEG_K = 14
N_COEF = N_SEG * SEG_K
SEG_SPLITS = (50.0, 230.0)        # hPa, interior segment boundaries
_LNP_LO = float(np.log(P_BOT))
_LNP_HI = float(np.log(P_TOP))
# Ascending log-pressure segment bounds: segment 0 covers the lowest
# pressures, segment N_SEG-1 ends at P_TOP.
_SEG_LNP = (_LNP_LO,) + tuple(float(np.log(s)) for s in SEG_SPLITS) + \
    (_LNP_HI,)


def curve_start_temperatures(device, dtype=torch.float64):
    """Start temperature (at 1100 hPa) of each of the 14,300 curves."""
    base = np.round(np.arange(T_MIN, T_MAX_EXCL, T_STEP), 2)
    starts = np.stack([base, base + CURVE_OFFSET], axis=1).reshape(-1)
    return torch.as_tensor(starts, dtype=dtype, device=device)


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


def integrate_between(t0, logp0, logp1, n_substeps=16):
    """Integrate T from log-pressure ``logp0`` to ``logp1`` (tensors
    broadcastable with ``t0``) with fixed RK4 substeps."""
    h = (logp1 - logp0) / n_substeps
    t = t0
    for i in range(n_substeps):
        t = rk4_step(logp0 + i * h, h, t)
    return t


def _cheb_nodes(n_coef, lo=_LNP_LO, hi=_LNP_HI):
    """Chebyshev-Gauss nodes mapped to [lo, hi] log-pressure, descending
    in p."""
    i = np.arange(n_coef)
    u = np.cos(np.pi * (i + 0.5) / n_coef)          # 1 -> -1
    lnp = 0.5 * (hi + lo) + 0.5 * (hi - lo) * u
    return u, lnp


def _cheb_transform_matrix(n_coef):
    """DCT matrix: coefficients = M @ values-at-Gauss-nodes."""
    i = np.arange(n_coef)
    k = i[:, None]
    M = (2.0 / n_coef) * np.cos(np.pi * k * (i + 0.5) / n_coef)
    M[0] *= 0.5
    return M


def build_spectral(device, dtype=torch.float64, seg_k=SEG_K,
                   n_substeps=64):
    """Chebyshev-fit every curve per segment by integrating the ODE through
    the union of all segments' Gauss nodes, in descending pressure.

    Returns (N_CURVES, N_SEG * seg_k): segment 0 (lowest pressures) first,
    each segment's ``seg_k`` coefficients contiguous.
    """
    per_seg = [_cheb_nodes(seg_k, _SEG_LNP[s], _SEG_LNP[s + 1])[1]
               for s in range(N_SEG)]
    lnp_nodes = np.concatenate(per_seg)
    order = np.argsort(-lnp_nodes)                  # integrate descending p
    lnp_sorted = lnp_nodes[order]
    starts = np.concatenate([[np.log(P_TOP)], lnp_sorted[:-1]])
    segs = torch.as_tensor(np.stack([starts, lnp_sorted], axis=1),
                           dtype=dtype, device=device)

    t = curve_start_temperatures(device, dtype)
    t_sorted = []
    for seg in segs:
        t = integrate_between(t, seg[0], seg[1], n_substeps=n_substeps)
        t_sorted.append(t)
    t_sorted = torch.stack(t_sorted)                # (nodes, N_CURVES)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    t_nodes = t_sorted[torch.as_tensor(inv, device=device)]
    M = torch.as_tensor(_cheb_transform_matrix(seg_k), dtype=dtype,
                        device=device)
    coeffs = [(M @ t_nodes[s * seg_k:(s + 1) * seg_k]).T
              for s in range(N_SEG)]
    return torch.cat(coeffs, -1)


def _eval_spectral(coeffs, pressure, log_pressure=None):
    """Piecewise-Clenshaw evaluation of per-column segment-Chebyshev
    coefficients (…, N_SEG*seg_k) at per-level pressures (…, L): each level
    picks its segment from its log-pressure, maps it to [-1, 1] (clipped)
    and sums the segment's series."""
    lnp = log_pressure if log_pressure is not None else torch.log(pressure)
    K_tot = coeffs.shape[-1]
    seg_k = K_tot // N_SEG
    if seg_k * N_SEG != K_tot:
        raise ValueError(f'{K_tot} coefficients do not split into '
                         f'{N_SEG} segments')
    in_low = [lnp < _SEG_LNP[s + 1] for s in range(N_SEG - 1)]

    def select_seg(values):
        out = values[N_SEG - 1]
        for s in range(N_SEG - 2, -1, -1):
            out = torch.where(in_low[s], values[s], out)
        return out

    scales = [2.0 / (_SEG_LNP[s + 1] - _SEG_LNP[s]) for s in range(N_SEG)]
    shifts = [(_SEG_LNP[s + 1] + _SEG_LNP[s]) /
              (_SEG_LNP[s + 1] - _SEG_LNP[s]) for s in range(N_SEG)]
    scale = select_seg([torch.tensor(s, dtype=lnp.dtype, device=lnp.device)
                        for s in scales])
    shift = select_seg([torch.tensor(s, dtype=lnp.dtype, device=lnp.device)
                        for s in shifts])
    u = torch.clamp(lnp * scale - shift, -1.0, 1.0)

    def seg_coef(k):
        return select_seg([coeffs[..., s * seg_k + k, None]
                           for s in range(N_SEG)])

    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    two_u = 2.0 * u
    for k in range(seg_k - 1, 0, -1):
        b1, b2 = seg_coef(k) + two_u * b1 - b2, b1
    return seg_coef(0) + u * b1 - b2


class AdiabatTables(nn.Module):
    """The moist-adiabat tables as module buffers; ``.to(device)`` moves
    them.

    ``coeffs``: (N_CURVES, N_COEF) piecewise Chebyshev coefficients of
    T(ln p) per curve, read by the fused solve and ``moist_lapse``'s
    default mode.  Optional, for ``moist_lapse``'s table modes only:
    ``curves`` (N_CURVES, N_PRES), every curve's temperature on the 0.5 hPa
    grid, and ``lookup`` (N_PRES, N_TEMP), the fractional curve index of
    each (pressure, temperature) cell.
    """

    def __init__(self, coeffs, curves=None, lookup=None):
        super().__init__()
        if coeffs is None:
            raise ValueError('coeffs is required')
        for name, x, shape in (('coeffs', coeffs, (N_CURVES, N_COEF)),
                               ('curves', curves, (N_CURVES, N_PRES)),
                               ('lookup', lookup, (N_PRES, N_TEMP))):
            if x is not None and tuple(x.shape) != shape:
                raise ValueError(f'{name} must be {shape}, got '
                                 f'{tuple(x.shape)}')
            self.register_buffer(name, x)

    @classmethod
    def from_numpy(cls, coeffs, device, dtype, curves=None, lookup=None):
        """Tables from host arrays, e.g. the JAX package's
        ``np.asarray(tables.coeffs)`` (and ``tables.curves``,
        ``tables.lookup``).  ``coeffs`` and ``curves`` take ``dtype``;
        ``lookup`` keeps its own (float32 in the JAX package)."""
        def put(x, dt=None):
            return None if x is None else torch.tensor(
                np.asarray(x), dtype=dt, device=device)
        return cls(put(coeffs, dtype), put(curves, dtype), put(lookup))

    @classmethod
    def build(cls, device, dtype):
        """Build the coefficients on ``device`` in float64, then cast."""
        return cls(build_spectral(device).to(dtype))


@functools.lru_cache(maxsize=8)
def default_tables(device, dtype):
    """Tables built once per (device, dtype) for callers that pass none."""
    return AdiabatTables.build(device, dtype)


def curve_index_integrate(parcel_pressure, parcel_temperature,
                          n_substeps=12):
    """Fractional curve index by backward ODE integration to 1100 hPa:
    fidx = (T_start - 173 K) / 0.01 K.  NaN state or a start temperature
    outside the curve family gives NaN."""
    pp, pt = parcel_pressure, parcel_temperature
    valid = notnan(pp) & notnan(pt) & (pp > 0)
    lp0 = torch.log(torch.where(valid, pp, P_TOP))
    t0 = torch.where(valid, pt, 273.15)
    t_start = integrate_between(t0, lp0, torch.full_like(lp0, _LNP_HI),
                                n_substeps=n_substeps)
    spacing = T_STEP / 2.0            # 0.01 K between consecutive curves
    fidx = (t_start - T_MIN) / spacing
    # Envelope: within one curve spacing of the family.
    ok = valid & (fidx >= -1.0) & (fidx <= N_CURVES)
    return torch.where(ok, torch.clamp(fidx, 0.0, N_CURVES - 1.0), torch.nan)


def blend_coeff_rows(tables, fidx):
    """Blend the two coefficient rows bracketing fractional curve index
    ``fidx`` (…,) into one (…, K) row per column; NaN ``fidx`` gives an
    all-NaN row."""
    nan = torch.isnan(fidx)
    safe = torch.where(nan, 0.0, fidx)
    c0 = torch.clamp(torch.floor(safe), 0, N_CURVES - 2).to(torch.int64)
    a = torch.clamp(safe - c0, 0.0, 1.0)[..., None]
    coeffs = tables.coeffs
    row = coeffs[c0] * (1.0 - a) + coeffs[c0 + 1] * a
    return torch.where(nan[..., None], torch.nan, row)


def _table(tables, name, mode):
    """The ``curves`` or ``lookup`` buffer, or a ValueError naming it."""
    x = getattr(tables, name)
    if x is None:
        raise ValueError(f'moist_lapse {mode} needs tables.{name}, and these '
                         f'tables have none: pass {name}= to '
                         f'AdiabatTables.from_numpy')
    return x


def _grid_index(x, n, rounding):
    """``rounding`` (floor or round) of a fractional grid index, clamped to
    [0, n] as int64.  A NaN index (a NaN parcel, masked by the caller)
    reads cell 0."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(rounding(x), 0, n).to(torch.int64)


def _curve_index(tables, parcel_pressure, parcel_temperature,
                 bilinear=True):
    """Fractional curve index of a parcel state from the lookup table:
    bilinear over the four neighbouring (p, T) cells, falling back to the
    nearest cell where a corner is outside the envelope; or the nearest
    cell alone (clamped at the grid edges).  NaN outside the envelope."""
    mode = "index_mode='bilinear'" if bilinear else "index_mode='nearest'"
    lookup = _table(tables, 'lookup', mode)
    fp_ = (P_TOP - parcel_pressure) / P_STEP
    ft = (parcel_temperature - T_MIN) / T_STEP
    ipn = _grid_index(fp_, N_PRES - 1, torch.round)
    itn = _grid_index(ft, N_TEMP - 1, torch.round)
    nearest = lookup[ipn, itn]
    if not bilinear:
        return nearest
    ip0 = _grid_index(fp_, N_PRES - 2, torch.floor)
    it0 = _grid_index(ft, N_TEMP - 2, torch.floor)
    ap = torch.clamp(fp_ - ip0, 0.0, 1.0)
    at = torch.clamp(ft - it0, 0.0, 1.0)
    f00 = lookup[ip0, it0]
    f01 = lookup[ip0, it0 + 1]
    f10 = lookup[ip0 + 1, it0]
    f11 = lookup[ip0 + 1, it0 + 1]
    bil = ((1 - ap) * ((1 - at) * f00 + at * f01) +
           ap * ((1 - at) * f10 + at * f11))
    return torch.where(torch.isnan(bil), nearest, bil)


def _interp_curve(tables, fidx, pressure, curve_blend=True):
    """The adiabat of fractional index ``fidx`` at ``pressure``, linear in
    pressure on the 0.5 hPa grid: the two bracketing curves blended by the
    fractional part (``curve_blend``) or the nearest curve alone."""
    curves = _table(tables, 'curves', 'with curve_blend=False or '
                    'pointwise=True')
    fi = (P_TOP - pressure) / P_STEP
    i0 = torch.clamp(torch.floor(fi), 0, N_PRES - 2).to(torch.int64)
    t = fi - i0
    if fidx.dim() < pressure.dim():
        fidx = fidx[..., None]
    if curve_blend:
        c0 = torch.clamp(torch.floor(fidx), 0, N_CURVES - 2).to(torch.int64)
        a = torch.clamp(fidx - c0, 0.0, 1.0)
        lo = curves[c0, i0] * (1.0 - t) + curves[c0, i0 + 1] * t
        hi = curves[c0 + 1, i0] * (1.0 - t) + curves[c0 + 1, i0 + 1] * t
        return lo * (1.0 - a) + hi * a
    idx = torch.clamp(torch.round(fidx), 0, N_CURVES - 1).to(torch.int64)
    return curves[idx, i0] * (1.0 - t) + curves[idx, i0 + 1] * t


def _is_pointwise(pointwise, parcel_temperature, pressure):
    """``pointwise`` unless None; None means "the parcel state has exactly
    the pressure's shape"."""
    if pointwise is not None:
        return pointwise
    return parcel_temperature is not None and (
        tuple(np.shape(parcel_temperature)) == tuple(pressure.shape))


def moist_lapse(pressure, parcel_temperature, parcel_pressure=None,
                tables=None, bilinear=True, curve_blend=True,
                index_mode=None, pointwise=None):
    """Temperature of parcels lifted moist-adiabatically, via the tables.

    ``pressure``: (…, L) levels to lift to, or with ``pointwise`` one level
    per parcel (pressure and parcel state of one shape);
    ``parcel_temperature``/``parcel_pressure``: (…) start state
    (``parcel_pressure`` defaults to the first level, or to the pressure
    itself pointwise).  ``pointwise=None`` decides by exact shape equality.

    ``index_mode``: ``'integrate'`` (default: backward ODE integration,
    :func:`curve_index_integrate`), ``'bilinear'`` or ``'nearest'`` (the
    lookup table's cells); ``bilinear=False`` is an alias for
    ``'nearest'``.  ``curve_blend`` blends the two bracketing curves; off,
    the nearest curve alone.  The default (integrate, blended, not
    pointwise) evaluates the blended spectral row and needs only
    ``tables.coeffs``; every other mode reads ``tables.curves`` and the
    table index modes ``tables.lookup``, and raises without them.

    Invalid parcels, parcels outside the tables and level pressures outside
    1100-2.5 hPa give NaN.
    """
    if tables is None:
        tables = default_tables(pressure.device, pressure.dtype)
    pointwise = _is_pointwise(pointwise, parcel_temperature, pressure)
    if parcel_pressure is None:
        parcel_pressure = pressure if pointwise else pressure[..., 0]
    pt = tensor_like(parcel_temperature, pressure)
    pp = tensor_like(parcel_pressure, pressure)
    if not pointwise:
        batch = torch.broadcast_shapes(pt.shape, pp.shape,
                                       pressure.shape[:-1])
        pressure = pressure.expand(batch + pressure.shape[-1:])

    if index_mode is None:
        index_mode = 'integrate' if bilinear else 'nearest'
    if index_mode == 'integrate':
        fidx = curve_index_integrate(pp, pt)
    elif index_mode in ('bilinear', 'nearest'):
        fidx = _curve_index(tables, pp, pt,
                            bilinear=index_mode == 'bilinear')
    else:
        raise ValueError(f'unknown index_mode {index_mode!r}')
    valid = notnan(fidx) & notnan(pt) & notnan(pp)
    fidx = torch.where(valid, fidx, 0.0).to(tables.coeffs.dtype)

    safe_p = torch.where(torch.isnan(pressure), P_TOP, pressure)
    if curve_blend and not pointwise:
        out = _eval_spectral(blend_coeff_rows(tables, fidx), safe_p)
    elif pointwise:
        out = _interp_curve(tables, fidx[..., None], safe_p[..., None],
                            curve_blend=curve_blend)[..., 0]
    else:
        out = _interp_curve(tables, fidx, safe_p, curve_blend=curve_blend)

    ok = (pressure >= P_BOT) & (pressure <= P_TOP)
    ok = ok & (valid if pointwise else valid[..., None])
    return torch.where(ok, out, torch.nan)


def moist_lapse_integrate(pressure, parcel_temperature, parcel_pressure=None,
                          n_substeps=32, tables=None, pointwise=None):
    """Direct RK4 integration per query: the accuracy oracle.

    Walks the levels in order from the parcel state along one
    pseudoadiabat (``n_substeps`` RK4 steps per level), a NaN level giving
    NaN and being skipped.  ``tables`` is accepted and ignored, so the
    signature matches :func:`moist_lapse`; ``pointwise`` as there.
    """
    pointwise = _is_pointwise(pointwise, parcel_temperature, pressure)
    levels = pressure[..., None] if pointwise else pressure
    if parcel_pressure is None:
        parcel_pressure = levels[..., 0]
    t0 = tensor_like(parcel_temperature, levels).to(levels.dtype)
    p0 = tensor_like(parcel_pressure, levels).to(levels.dtype)
    batch = torch.broadcast_shapes(t0.shape, p0.shape, levels.shape[:-1])
    t0, p0 = t0.expand(batch), p0.expand(batch)
    levels = levels.expand(batch + levels.shape[-1:])

    start_valid = notnan(t0) & notnan(p0)
    lp_cur = torch.log(torch.where(start_valid, p0, P_TOP))
    t_cur = torch.where(start_valid, t0, 273.15)
    outs = []
    for k in range(levels.shape[-1]):
        p_k = levels[..., k]
        valid = notnan(p_k) & (p_k > 0)
        lp_new = torch.where(valid, torch.log(torch.where(valid, p_k, 1.0)),
                             lp_cur)
        t_cur = integrate_between(t_cur, lp_cur, lp_new,
                                  n_substeps=n_substeps)
        lp_cur = lp_new
        outs.append(torch.where(valid, t_cur, torch.nan))
    out = torch.stack(outs, -1) if outs else levels.clone()
    out = torch.where(start_valid[..., None], out, torch.nan)
    return out[..., 0] if pointwise else out
