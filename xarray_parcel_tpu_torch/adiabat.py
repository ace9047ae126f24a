"""Moist (pseudo)adiabat engine: RK4 integrator, the table construction and
the table consumer ``moist_lapse``.

Port of ``xarray_parcel_tpu.adiabat``.  The curve family is 14,300
pseudoadiabats whose start temperatures at 1100 hPa lie on a 0.01 K grid.
Each curve is stored as piecewise Chebyshev coefficients of T(ln p): three segments split at 50 and 230 hPa, 14 terms
each.  A parcel's fractional curve index comes from integrating the ODE
backward to 1100 hPa; the two bracketing coefficient rows are blended into
one row per column, which the CAPE/CIN kernel (and ``moist_lapse``'s
default mode) evaluates at every level.

``build_spectral`` makes the coefficients, ``generate_curves`` every
curve's temperature on the 0.5 hPa grid and ``build_lookup`` the
(pressure, temperature) -> curve index table, on any device, in float64.
``load_moist_adiabat_lookups`` builds all three once, caches them in the
port's own file under ``adiabat_lookups/`` and makes them the default
tables; without it ``default_tables`` builds the coefficients alone, which
is all the default path reads.  ``AdiabatTables.save``/``load`` use the
JAX package's ``.npz`` layout (``curves``, ``lookup``, ``coeffs``), so a
table file written by either package loads into the other.
``moist_lapse_integrate`` is the exact-ODE oracle.
"""

import os
import zipfile

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

# RK4 refinement of generate_curves: the largest log-pressure step.
# ln(1100/2.5) is about 6.09 in all.
MAX_DLOGP = 2e-3

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


def round_to(x, to, dp=2):
    """Round ``x`` to the nearest multiple of ``to``, then to ``dp`` decimal
    places: the reference's table-grid snapping helper."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return torch.round(torch.round(x / to) * to, decimals=dp)


def pressure_grid(device=None, dtype=torch.float64):
    """The descending uniform pressure grid [1100, 1099.5, …, 2.5] hPa."""
    return torch.as_tensor(np.round(np.arange(1100.0, 2.0, -0.5), 1),
                           dtype=dtype, device=device)


def _refined_grid():
    """The integration grid of generate_curves: the output pressure grid with
    each interval subdivided so that every RK4 step has |dlog p| <=
    MAX_DLOGP.  Returns (log-pressures in integration order, descending p;
    indices of the output pressures within them), as numpy arrays."""
    logp = np.log(np.round(np.arange(1100.0, 2.0, -0.5), 1))
    pts = [logp[0]]
    out_idx = [0]
    for k in range(len(logp) - 1):
        a, b = logp[k], logp[k + 1]
        n_sub = max(1, int(np.ceil(abs(b - a) / MAX_DLOGP)))
        pts.extend(np.linspace(a, b, n_sub + 1)[1:].tolist())
        out_idx.append(len(pts) - 1)
    return np.asarray(pts), np.asarray(out_idx)


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


def generate_curves(device, dtype=torch.float64, starts=None):
    """The adiabat family on the 0.5 hPa grid: one RK4 walk down the
    refined log-pressure grid for all curves at once, keeping the output
    pressures.

    Returns (N_CURVES, N_PRES), the temperature of every curve at every
    grid pressure; with ``starts`` (a 1-D tensor of start temperatures at
    1100 hPa) only those curves.
    """
    grid, out_idx = _refined_grid()
    t = (curve_start_temperatures(device, dtype) if starts is None
         else starts.to(device=device, dtype=dtype))
    curves = torch.empty((len(out_idx), t.shape[0]), dtype=dtype,
                         device=device)
    curves[0] = t
    keep = {int(i): k for k, i in enumerate(out_idx)}
    lp = torch.as_tensor(grid, dtype=dtype, device=device)
    steps = lp[1:] - lp[:-1]
    for i, h in enumerate(steps):
        t = rk4_step(lp[i], h, t)
        if i + 1 in keep:
            curves[keep[i + 1]] = t
    return curves.T.contiguous()


def build_lookup(curves, rows=256):
    """The (pressure, temperature) -> fractional curve index table.

    At each grid pressure the curve temperatures ``curves[:, ip]`` increase
    strictly with the curve index (pseudoadiabats do not cross), so the
    curve through a (p, T) cell has a fractional index by inverse
    interpolation.  Cells further than half a temperature step outside the
    family are NaN.  Works through the pressures ``rows`` at a time.

    Returns float32 (N_PRES, N_TEMP).
    """
    tq = T_MIN + T_STEP * torch.arange(N_TEMP, dtype=curves.dtype,
                                       device=curves.device)
    n = curves.shape[0]
    out = torch.empty((curves.shape[1], N_TEMP), dtype=torch.float32,
                      device=curves.device)
    for r0 in range(0, curves.shape[1], rows):
        col = curves[:, r0:r0 + rows].T.contiguous()    # (rows, N_CURVES)
        q = tq.expand(col.shape[0], -1).contiguous()
        hi = torch.searchsorted(col, q, side='left').clamp(1, n - 1)
        lo = hi - 1
        c_lo, c_hi = col.gather(-1, lo), col.gather(-1, hi)
        fidx = lo + ((q - c_lo) / (c_hi - c_lo)).clamp(0.0, 1.0)
        valid = ((q >= col[:, :1] - T_STEP / 2.0) &
                 (q <= col[:, -1:] + T_STEP / 2.0))
        out[r0:r0 + rows] = torch.where(valid, fidx, torch.nan).to(
            torch.float32)
    return out


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


def _save_npz(path, curves, lookup, coeffs):
    """Atomic compressed save of host arrays in the JAX package's layout:
    an interrupted write never leaves a corrupt file, and concurrent savers
    do not share a temporary name."""
    tmp = f'{path}.{os.getpid()}.tmp'
    arrays = {'coeffs': coeffs}
    if curves is not None:
        arrays['curves'] = curves
    if lookup is not None:
        arrays['lookup'] = lookup
    try:
        with open(tmp, 'wb') as f:   # a handle: savez would append .npz
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


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
        ``lookup`` keeps its own (float32 in both packages).  ``coeffs``
        may be None when ``curves`` come with a file that has none: they
        are then built on ``device``."""
        def put(x, dt=None):
            return None if x is None else torch.tensor(
                np.asarray(x), dtype=dt, device=device)
        if coeffs is None:
            coeffs = build_spectral(device).to(dtype)
        return cls(put(coeffs, dtype), put(curves, dtype), put(lookup))

    @classmethod
    def build(cls, device, dtype, with_tables=False):
        """Build on ``device`` in float64, then cast: the coefficients,
        and with ``with_tables`` the curves and the lookup table too."""
        coeffs = build_spectral(device).to(dtype)
        if not with_tables:
            return cls(coeffs)
        curves = generate_curves(device)
        return cls(coeffs, curves.to(dtype), build_lookup(curves))

    def astype(self, dtype):
        """The tables with ``coeffs`` and ``curves`` as ``dtype`` (the
        lookup table keeps float32)."""
        return AdiabatTables(
            self.coeffs.to(dtype),
            None if self.curves is None else self.curves.to(dtype),
            self.lookup)

    def save(self, path):
        """Write the tables as a compressed ``.npz`` with the keys
        ``coeffs``, ``curves`` and ``lookup`` (those there are)."""
        def host(x):
            return None if x is None else x.detach().cpu().numpy()
        _save_npz(path, host(self.curves), host(self.lookup),
                  host(self.coeffs))

    @classmethod
    def load(cls, path, device, dtype=None):
        """Read tables saved by :meth:`save` (or by the JAX package's
        ``AdiabatTables.save``) onto ``device``; ``dtype`` defaults to the
        stored curves' (else coefficients').  Coefficients that are missing
        or not in the piecewise layout are rebuilt."""
        with np.load(path) as f:
            arrays = {k: np.asarray(f[k]) for k in f.files}
        coeffs = arrays.get('coeffs')
        if coeffs is not None and coeffs.shape[-1] != N_COEF:
            coeffs = None
        stored = arrays['curves'] if 'curves' in arrays else coeffs
        if dtype is None:
            dtype = (torch.float64 if stored is None
                     or stored.dtype.itemsize == 8 else torch.float32)
        return cls.from_numpy(coeffs, device, dtype,
                              curves=arrays.get('curves'),
                              lookup=arrays.get('lookup'))


# The default tables: what load_moist_adiabat_lookups loaded, else the
# coefficients alone, built at first use per (device, dtype).
_LOADED = None
_LOADED_SOURCE = None
_DEFAULTS = {}
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'adiabat_lookups')


def _stored_dtype(path):
    """Dtype of a table file's curves from the ``.npy`` header alone,
    without decompressing the array.  None when the file is unreadable or
    holds no curves."""
    from numpy.lib import format as npformat
    try:
        with zipfile.ZipFile(path) as z, z.open('curves.npy') as f:
            version = npformat.read_magic(f)
            if version == (1, 0):
                _, _, dtype = npformat.read_array_header_1_0(f)
            else:
                _, _, dtype = npformat.read_array_header_2_0(f)
            return dtype
    except (KeyError, OSError, ValueError, zipfile.BadZipFile):
        return None


def load_moist_adiabat_lookups(cache_path=None, regenerate=False, dtype=None,
                               device=None):
    """Load, or build and cache, the default tables (coefficients, curves
    and lookup table), and return them.

    The cache is the port's own file, keyed by dtype:
    ``adiabat_lookups/torch_adiabat_tables_f32.npz`` or ``_f64.npz`` beside
    the package, or ``cache_path``, or ``$XPARCEL_TORCH_TABLE_CACHE``.  A
    file whose stored precision covers the request is loaded and cast; a
    narrower or unreadable one is rebuilt, as is any with ``regenerate``.
    The build runs on ``device`` (None: the GPU) in float64.  ``dtype``
    defaults to torch's default dtype.
    """
    global _LOADED, _LOADED_SOURCE
    from ._device import resolve_device
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'tables are float32 or float64, not {dtype}')
    wide = dtype == torch.float64
    path = (cache_path or os.environ.get('XPARCEL_TORCH_TABLE_CACHE')
            or os.path.join(
                _CACHE_DIR,
                f'torch_adiabat_tables_{"f64" if wide else "f32"}.npz'))
    if (not regenerate and _LOADED is not None and _LOADED_SOURCE == path
            and _LOADED.coeffs.dtype == dtype
            and _LOADED.coeffs.device == device):
        return _LOADED
    stored = None if regenerate else _stored_dtype(path)
    if stored is not None and stored.itemsize >= (8 if wide else 4):
        tables = AdiabatTables.load(path, device, dtype)
    else:
        tables = AdiabatTables.build(device, dtype, with_tables=True)
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tables.save(path)
    _LOADED, _LOADED_SOURCE = tables, path
    _DEFAULTS.clear()
    return tables


def default_tables(device, dtype):
    """The tables for callers that pass none: those that
    :func:`load_moist_adiabat_lookups` loaded, moved to ``device`` and
    ``dtype``; before any load, the coefficients alone, built there.
    Cached per (device, dtype)."""
    key = (torch.device(device), dtype)
    if key not in _DEFAULTS:
        if _LOADED is None:
            _DEFAULTS[key] = AdiabatTables.build(*key)
        elif (_LOADED.coeffs.device, _LOADED.coeffs.dtype) == key:
            _DEFAULTS[key] = _LOADED
        else:
            _DEFAULTS[key] = _LOADED.astype(dtype).to(key[0])
    return _DEFAULTS[key]


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


class MissingTableError(ValueError):
    """A table mode was asked of tables that lack the array ``table``
    (``'curves'`` or ``'lookup'``)."""

    def __init__(self, table, mode):
        super().__init__(
            f'moist_lapse {mode} needs tables.{table}, and these tables have '
            f'none: call load_moist_adiabat_lookups() or '
            f'AdiabatTables.build(..., with_tables=True)')
        self.table = table


def _table(tables, name, mode):
    """The ``curves`` or ``lookup`` buffer, or a
    :class:`MissingTableError` naming it."""
    x = getattr(tables, name)
    if x is None:
        raise MissingTableError(name, mode)
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
