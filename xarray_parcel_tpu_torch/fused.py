"""Fused per-column CAPE/CIN solve: the CUDA kernel and its plain twin.

Port of ``xarray_parcel_tpu.fused``.  One solve per column: the parcel
temperature track (dry Poisson below the LCL, the blended spectral moist
adiabat above it), parcel and environment virtual temperature, the LCL
spliced in after the column's leading-NaN prefix, the parcel/environment
crossing set in log p, LFC/EL under the USAF1990 rules, exact-area CAPE/CIN
and the 500 hPa lifted index; optionally the spliced column's pressure,
parcel and environment temperature tracks (the profile).

On a CUDA tensor the solve runs in the hand-written kernel
``csrc/fused_cape.cu`` (one warp per column, its lanes striding over the
levels); on a CPU tensor it runs in ``_column_program``, the same solve as
vectorised torch on (B, L) tensors.
The O(B) pre-pass (LCL fixed point, curve index, coefficient-row blend,
first-valid level) runs likewise: on a CUDA tensor in one launch of
``csrc/prepass.cu`` (a thread per column), on a CPU tensor in its plain
twin ``_prepass_twin``.  Both are called through the seam
(:mod:`._kernels`), whose gradient is the twin's VJP, so gradients reach
the parcel state through the pre-pass.

The solve takes four options with the JAX package's meaning
(:func:`solve_options`); the kernel's default instance compiles them away
and a second instance reads them from a flags word.
"""

import math

import torch

from . import adiabat, thermo
from . import constants as c
from ._build import span
from ._kernels import Kernel
from .adiabat import P_BOT, P_TOP, _eval_spectral
from .cape import cape_cin_base, lfc_el
from .lcl import lcl
from .ops import (find_intersections, first_valid_index, insert_level,
                  interp_many, notnan, safe_log)

#: Order of the kernel's (and the twin's) output rows.
OUTPUTS = ('cape', 'cin', 'lfc_pressure', 'lfc_temperature', 'el_pressure',
           'el_temperature', 'lifted_index')
#: Order of the optional profile tracks, each (B, L+1).
PROFILE = ('pressure', 'temperature', 'environment_temperature')
#: Order of the per-column scalar inputs.
SCALARS = ('lcl_pressure', 'lcl_temperature', 'lcl_virtual_temperature',
           'mixing_ratio', 'temperature', 'pressure')
#: Bits of the kernel's flags word, one per non-default option.
FLAG_REAL_TEMPERATURE = 1       # virtual_temperature_correction=False
FLAG_LINEAR_LCL = 2             # lcl_interp='linear'
FLAG_SIGNED_AREAS = 4           # pos_cape_neg_cin=False
FLAG_ZERO_CIN = 8               # post_zero_cin=True


def solve_options(virtual_temperature_correction=True, lcl_interp='log',
                  pos_cape_neg_cin=True, post_zero_cin=False):
    """The solve's options as a dict with every default filled in.

    ``virtual_temperature_correction``: search LFC/EL and integrate on the
    virtual-temperature tracks (else on the real ones, with the LCL
    temperature for the LCL's).  ``lcl_interp``: ``'log'`` or ``'linear'``,
    how the environment is interpolated at the LCL pressure.
    ``pos_cape_neg_cin``: only positive areas count toward CAPE and only
    negative toward CIN (else every area of the window, with its sign).
    ``post_zero_cin``: clamp a positive (or NaN) CIN to zero.  An unknown
    keyword raises ``TypeError``."""
    if lcl_interp not in ('log', 'linear'):
        raise ValueError(f"lcl_interp must be 'log' or 'linear', "
                         f'not {lcl_interp!r}')
    return {'virtual_temperature_correction':
            bool(virtual_temperature_correction),
            'lcl_interp': lcl_interp,
            'pos_cape_neg_cin': bool(pos_cape_neg_cin),
            'post_zero_cin': bool(post_zero_cin)}


def option_flags(options):
    """The kernel's flags word for a :func:`solve_options` dict (0 for the
    defaults)."""
    o = solve_options(**options)
    return ((0 if o['virtual_temperature_correction']
             else FLAG_REAL_TEMPERATURE)
            | (FLAG_LINEAR_LCL if o['lcl_interp'] == 'linear' else 0)
            | (0 if o['pos_cape_neg_cin'] else FLAG_SIGNED_AREAS)
            | (FLAG_ZERO_CIN if o['post_zero_cin'] else 0))


def _column_program(p, t, td, row, lcl_p, lcl_t, lcl_vt, w0, t0, p0, k0,
                    with_profile=False, virtual_temperature_correction=True,
                    lcl_interp='log', pos_cape_neg_cin=True,
                    post_zero_cin=False):
    """The per-column CAPE/CIN solve on (B, L) tensors (the kernel's plain
    twin).  ``row``: (B, K) blended coefficient rows (NaN row = parcel
    outside the adiabat family); the rest are (B,) per-column scalars,
    ``k0`` the integer first-valid level; the options as in
    :func:`solve_options`.  Returns a dict of (B,) outputs
    named as in :data:`OUTPUTS`; with ``with_profile`` also ``profile``,
    the (B, L+1) spliced tracks in :data:`PROFILE` order."""
    lcl_pb = lcl_p[..., None]

    # Tracks are computed on safe finite dummies; NaN levels get NaN after.
    validp = notnan(p)
    safe_p = torch.where(validp, p, P_TOP)
    lp = safe_log(p)
    safe_lp = torch.where(validp, lp, math.log(P_TOP))

    dry = t0[..., None] * torch.exp(
        c.kappa * (safe_lp - torch.log(p0)[..., None]))
    moist = _eval_spectral(row, safe_p, log_pressure=safe_lp)
    moist = torch.where((p >= P_BOT) & (p <= P_TOP), moist, torch.nan)
    temp = torch.where(p >= lcl_pb, dry, moist)
    temp = torch.where(validp, temp, torch.nan)

    validt = notnan(temp)
    safe_temp = torch.where(validt, temp, 273.15)
    sat_w = thermo.saturation_mixing_ratio(safe_p, safe_temp)
    w = torch.where(p <= lcl_pb, sat_w, w0[..., None])
    vt = torch.where(validt, thermo.virtual_temperature(safe_temp, w),
                     torch.nan)

    valid_env = validp & notnan(t) & notnan(td)
    safe_t = torch.where(valid_env, t, 273.15)
    safe_td = torch.where(valid_env, td, 263.15)
    env_vt = torch.where(
        valid_env,
        thermo.virtual_temperature(
            safe_t, thermo.mixing_ratio(safe_t, safe_td, safe_p)),
        torch.nan)

    llcl = safe_log(lcl_p)
    t_at, td_at = interp_many((t, td), p, lcl_p, log=lcl_interp == 'log',
                              log_coords=lp)
    envvt_at = thermo.virtual_temperature(
        t_at, thermo.mixing_ratio(t_at, td_at, lcl_p))

    if virtual_temperature_correction:
        parcel_track, env_track = vt, env_vt
        lcl_track, env_at = lcl_vt, envvt_at
    else:
        parcel_track, env_track = temp, t
        lcl_track, env_at = lcl_t, t_at

    fields = {'pressure': p, 'log_pressure': lp, 'parcel': parcel_track,
              'env': env_track, 'ptemp': temp, 'etemp': t}
    level = {'pressure': lcl_p, 'log_pressure': llcl, 'parcel': lcl_track,
             'env': env_at, 'ptemp': lcl_t, 'etemp': t_at}
    ins = insert_level(fields, level, lead=k0)
    ins_lp = ins['log_pressure']

    ints = find_intersections(ins['pressure'], ins['parcel'], ins['env'],
                              log_x=True, log_x_values=ins_lp,
                              log_outputs=True)
    sol = lfc_el(ins['pressure'], ins['parcel'], ins['env'], lcl_p, lcl_track,
                 intersections=ints, log_pressure=ins_lp,
                 log_lcl_pressure=llcl, intersections_in_log=True,
                 first_valid=k0)
    res = cape_cin_base(ins['pressure'], ins['env'], sol['lfc_pressure'],
                        sol['el_pressure'], ins['parcel'],
                        pos_cape_neg_cin=pos_cape_neg_cin,
                        post_zero_cin=post_zero_cin, intersections=ints,
                        log_pressure=ins_lp,
                        log_lfc_pressure=sol.pop('_lfc_log_pressure'),
                        log_el_pressure=sol.pop('_el_log_pressure'))
    env500, par500 = interp_many((ins['etemp'], ins['ptemp']),
                                 ins['pressure'], 500.0, log=True,
                                 log_coords=ins_lp)
    out = {**res, **sol, 'lifted_index': env500 - par500}
    if with_profile:
        out['profile'] = (ins['pressure'], ins['ptemp'], ins['etemp'])
    return out


def _column_outputs(p, t, td, row, scalars, k0, with_profile=False,
                    **options):
    """:func:`_column_program` on the kernel's packed arguments; returns
    the (7, B) output block in :data:`OUTPUTS` order, and with
    ``with_profile`` also the (3, B, L+1) tracks in :data:`PROFILE`
    order."""
    out = _column_program(p, t, td, row, *scalars.unbind(-1), k0,
                          with_profile=with_profile,
                          **solve_options(**options))
    block = torch.stack([out[k] for k in OUTPUTS])
    return (block, torch.stack(out['profile'])) if with_profile else block


def _solve_on_card(launch, p, t, td, row, scalars, k0, with_profile=False,
                   **options):
    """:data:`cape_cin_kernel` on CUDA tensors: the default options launch
    the library's ``fused_cape_cin_<dtype>`` entry point, any other setting
    its ``fused_cape_cin_flags_<dtype>``."""
    flags = option_flags(options)
    B, L = p.shape
    K = row.shape[-1]
    if (t.shape != (B, L) or td.shape != (B, L) or row.shape != (B, K)
            or scalars.shape != (B, len(SCALARS)) or k0.shape != (B,)):
        raise ValueError('kernel input shapes do not match')
    if k0.dtype != torch.int32 or k0.device != p.device:
        raise TypeError('k0 must be int32 on the inputs\' device')
    if K % adiabat.N_SEG:
        raise ValueError(f'row width {K} is not {adiabat.N_SEG} segments')
    floats = [x.contiguous() for x in (p, t, td, row, scalars)]
    k0 = k0.contiguous()
    out = torch.empty((len(OUTPUTS), B), dtype=p.dtype, device=p.device)
    prof = (torch.empty((len(PROFILE), B, L + 1), dtype=p.dtype,
                        device=p.device) if with_profile else None)
    if B > 0:
        pointers = [*(x.data_ptr() for x in floats), k0.data_ptr(),
                    out.data_ptr(),
                    None if prof is None else prof.data_ptr()]
        if flags:
            launch('fused_cape_cin_flags', pointers, B, L, K, flags)
        else:
            launch('fused_cape_cin', pointers, B, L, K)
    return (out, prof) if with_profile else out


#: The per-column solve on packed arguments: p/t/td (B, L), row (B, K),
#: scalars (B, 6) in :data:`SCALARS` order, all of one float dtype, and k0
#: (B,) int32, then ``with_profile`` and the options of
#: :func:`solve_options`.  Returns the (7, B) output block in
#: :data:`OUTPUTS` order, and with ``with_profile`` also the (3, B, L+1)
#: tracks in :data:`PROFILE` order.  CUDA tensors go to the hand-written
#: kernel (``cape_cin_kernel.launches`` counts each launch), CPU tensors to
#: the plain twin :func:`_column_outputs`; p, t, td, row and scalars take
#: a gradient (:class:`~._kernels.KernelCall`), k0 none.
cape_cin_kernel = Kernel('CAPE/CIN', _column_outputs, _solve_on_card,
                         differentiable=range(5))


def _prepass_twin(p, p0, t0, td0, tables):
    """The pre-pass as plain torch ops (the kernel's twin): the LCL of the
    parcel, its mixing ratio, the curve index, the blended coefficient row
    and the first valid level.  Returns (row, scalars, k0) as
    :func:`prepass_kernel` does."""
    lcls = lcl(p0, t0, td0)
    lcl_p = lcls['lcl_pressure']
    w0 = thermo.mixing_ratio(t0, td0, p0)
    fidx = adiabat.curve_index_integrate(lcl_p, lcls['lcl_temperature'])
    row = adiabat.blend_coeff_rows(tables, fidx).to(p.dtype)
    scalars = torch.stack([lcl_p, lcls['lcl_temperature'],
                           lcls['lcl_virtual_temperature'], w0, t0, p0],
                          -1).to(p.dtype)
    k0 = first_valid_index(p).to(torch.int32)
    return row, scalars, k0


def _prepass_on_card(launch, p, p0, t0, td0, tables):
    """:data:`prepass_kernel` on CUDA tensors: the library's
    ``parcel_prepass_<dtype>``."""
    coeffs = tables.coeffs
    if coeffs.dtype != p.dtype or coeffs.device != p.device:
        raise TypeError('the coefficient table must share the pressure\'s '
                        'dtype and device')
    if p.dim() != 2 or any(x.shape != p.shape[:1] for x in (p0, t0, td0)):
        raise ValueError('pre-pass takes (B, L) pressure and (B,) parcels')
    if coeffs.shape != (adiabat.N_CURVES, adiabat.N_COEF):
        raise ValueError(f'coefficient table is {tuple(coeffs.shape)}, not '
                         f'{(adiabat.N_CURVES, adiabat.N_COEF)}')
    B, L = p.shape
    ins = [x.contiguous() for x in (p, p0, t0, td0, coeffs)]
    row = torch.empty((B, adiabat.N_COEF), dtype=p.dtype, device=p.device)
    scalars = torch.empty((B, len(SCALARS)), dtype=p.dtype, device=p.device)
    k0 = torch.empty((B,), dtype=torch.int32, device=p.device)
    if B > 0:
        launch('parcel_prepass', [*(x.data_ptr() for x in ins),
                                  row.data_ptr(), scalars.data_ptr(),
                                  k0.data_ptr()], B, L)
    return row, scalars, k0


#: The pre-pass on the flat (B, L) pressure columns p and the (B,) parcel
#: state p0/t0/td0, with the table.  Returns the solve's per-column
#: arguments: row (B, K), the parcel's blended coefficient row (all NaN
#: outside the adiabat family), scalars (B, 6) in :data:`SCALARS` order
#: (the LCL's NaN where the parcel state holds a NaN) and k0 (B,) int32,
#: the first level of finite pressure.  CUDA tensors go to the
#: hand-written kernel (``prepass_kernel.launches`` counts each launch):
#: p, the parcel state and ``tables.coeffs`` must then share one float
#: dtype and the device.  CPU tensors go to the plain twin
#: :func:`_prepass_twin`.  The parcel state takes a gradient, through the
#: twin's VJP, so gradients reach it through the solve's arguments.
prepass_kernel = Kernel('pre-pass', _prepass_twin, _prepass_on_card,
                        differentiable=(1, 2, 3))

#: The O(B) pre-pass under the name the pipelines call it by.
prepass = prepass_kernel


def fused_cape_cin(pressure, temperature, dewpoint, parcel_pressure=None,
                   parcel_temperature=None, parcel_dewpoint=None,
                   tables=None, with_lifted_index=False,
                   with_profile=False, **options):
    """CAPE/CIN, LFC/EL (and optionally the lifted index) for an arbitrary
    parcel, via the fused solve.

    Environment columns are (…, L) tensors; parcel state is (…) and
    defaults to the lowest level.  Returns (res, sol) dicts of tensors of
    the broadcast batch shape: ``res`` holds cape, cin (and
    lifted_index), ``sol`` the LFC/EL pressures and temperatures.  With
    ``with_profile``, ``res['profile']`` holds the LCL-spliced column's
    ``pressure``, parcel ``temperature`` and ``environment_temperature``,
    each of shape batch + (L+1,).  ``options`` are the solve's
    (:func:`solve_options`: ``virtual_temperature_correction``,
    ``lcl_interp``, ``pos_cape_neg_cin``, ``post_zero_cin``); with the
    correction off the LFC/EL temperatures are real temperatures.

    The pre-pass and the solve are :data:`prepass_kernel` and
    :data:`cape_cin_kernel`: with grad mode on and an input requiring grad
    every output is differentiable.  On a CUDA tensor the parcel state and
    the table must be in the columns' dtype.
    """
    options = solve_options(**options)
    p, t, td = pressure, temperature, dewpoint
    if tables is None:
        tables = adiabat.default_tables(p.device, p.dtype)
    env = torch.broadcast_shapes(p.shape, t.shape, td.shape)
    batch_shape = torch.broadcast_shapes(
        env[:-1], *(x.shape for x in (parcel_pressure, parcel_temperature,
                                      parcel_dewpoint) if x is not None))
    L = env[-1]
    full = batch_shape + (L,)
    # One contiguous copy of a broadcast pressure, for the pre-pass and the
    # solve alike.
    p = p.expand(full).reshape(-1, L).contiguous()
    t = t.expand(full).reshape(-1, L)
    td = td.expand(full).reshape(-1, L)

    def flat_scalar(x, default):
        return default if x is None else x.expand(batch_shape).reshape(-1)

    p0 = flat_scalar(parcel_pressure, p[:, 0])
    t0 = flat_scalar(parcel_temperature, t[:, 0])
    td0 = flat_scalar(parcel_dewpoint, td[:, 0])

    with span('xparcel.prep.prepass'):
        row, scalars, k0 = prepass(p, p0, t0, td0, tables)
    args = (p, t.contiguous(), td.contiguous(), row, scalars)
    with span('xparcel.kernel.solve'):
        out = cape_cin_kernel(*args, k0, with_profile, **options)
    if with_profile:
        out, prof = out
    shaped = {k: v.reshape(batch_shape) for k, v in zip(OUTPUTS, out)}
    res = {'cape': shaped['cape'], 'cin': shaped['cin']}
    if with_lifted_index:
        res['lifted_index'] = shaped['lifted_index']
    if with_profile:
        res['profile'] = {k: v.reshape(batch_shape + (L + 1,))
                          for k, v in zip(PROFILE, prof)}
    sol = {k: shaped[k] for k in ('lfc_pressure', 'lfc_temperature',
                                  'el_pressure', 'el_temperature')}
    return res, sol


def fused_surface_cape_cin(pressure, temperature, dewpoint, **kwargs):
    """Surface-based CAPE/CIN via the fused solve (parcel = lowest
    level); ``kwargs`` as for :func:`fused_cape_cin`."""
    return fused_cape_cin(pressure, temperature, dewpoint, **kwargs)
