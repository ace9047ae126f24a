"""LFC/EL selection and CAPE/CIN integration.

Frozen copy of the program's ``cape``, with its signatures.  ``lfc_el``
compares linear pressures by default; ``cape_cin`` and the fused column
program call it with ``intersections_in_log=True``, so that the crossing
set comes in with log-pressure positions, every window comparison runs in
log space, and only the LFC/EL pressures are exponentiated.  ``cape_cin``
is the modular path: the parcel profile with the LCL spliced in, then the
same selection and integration.

* LFC = bottom-most (highest-pressure) increasing parcel/environment
  crossing above the LCL, with the USAF1990 LCL-substitution rules;
* EL = top-most decreasing crossing, above the LCL, and only when the parcel
  is no warmer than the environment at the top of the sounding;
* CAPE/CIN = Rd * (trapezoids of (T_parcel - T_env) d ln p between LFC and
  EL, resp. below the LFC, plus exact rectangles around each zero crossing).
"""

import torch

from . import constants as c
from .ops import (find_intersections, first_valid_index, nanmax, nanmin,
                  nansum, notnan, safe_exp, safe_log, tensor_like,
                  trap_around_zeros)
from .ops.integrate import gap_areas, select_areas
from .profile import parcel_profile_with_lcl


def lfc_el(pressure, parcel_temperature, temperature, lcl_pressure,
           lcl_temperature, intersections=None, log_pressure=None,
           log_lcl_pressure=None, intersections_in_log=False,
           first_valid=None):
    """Level of free convection and equilibrium level.

    ``pressure``/``parcel_temperature``/``temperature``: (…, L) tracks
    including the LCL level; ``lcl_pressure``/``lcl_temperature``: (…).
    Returns lfc/el pressure and temperature.  By default every pressure
    comparison runs on linear pressures, with a crossing set built here.
    ``intersections``: a precomputed ``find_intersections(p, pt, t,
    log_x=True)``.  With ``intersections_in_log`` the set holds log-pressure
    positions (``log_outputs=True``), every comparison runs in log space
    (``log_pressure``/``log_lcl_pressure`` skip the logs), only the LFC/EL
    pressures are exponentiated, and the private ``_lfc_log_pressure``/
    ``_el_log_pressure`` that :func:`cape_cin_base` takes are added.
    ``first_valid``: (…) index of the first valid level.
    """
    p, pt, t = torch.broadcast_tensors(pressure, parcel_temperature,
                                       temperature)
    lcl_p = tensor_like(lcl_pressure, p)
    lcl_t = tensor_like(lcl_temperature, p)
    if intersections_in_log:
        pw = log_pressure if log_pressure is not None else safe_log(p)
        lclw = (tensor_like(log_lcl_pressure, p)
                if log_lcl_pressure is not None else safe_log(lcl_p))
    else:
        pw, lclw = p, lcl_p
    # A self-built crossing set lives in the space of the comparisons.
    ints = (intersections if intersections is not None else
            find_intersections(
                p, pt, t, log_x=True,
                log_x_values=pw if intersections_in_log else None,
                log_outputs=intersections_in_log))
    if first_valid is None:
        first_valid = first_valid_index(p)

    # Gap/level k0 (the first valid level): a crossing at gap k0 is dropped
    # from the increasing set when parcel and environment share the first
    # level's value (8-ulp test), and always from the decreasing set.
    k0 = first_valid[..., None].to(torch.int64)
    gap0 = torch.arange(ints['increasing_x'].shape[-1],
                        device=p.device) == k0
    at_k0 = torch.arange(p.shape[-1], device=p.device) == k0
    t0 = nanmax(t, where=at_k0)
    pt0 = nanmax(pt, where=at_k0)
    tol = (8.0 * torch.finfo(t.dtype).eps
           * torch.maximum(torch.abs(t0), torch.abs(pt0)))
    same_first = (torch.abs(t0 - pt0) <= tol)[..., None]
    drop_inc = gap0 & same_first
    inc_x = torch.where(drop_inc, torch.nan, ints['increasing_x'])
    inc_y = torch.where(drop_inc, torch.nan, ints['increasing_y'])
    dec_x_above = torch.where(gap0, torch.nan, ints['decreasing_x'])
    dec_y_above = torch.where(gap0, torch.nan, ints['decreasing_y'])

    # LFC: bottom-most increasing crossing above the LCL.
    lfc_p = nanmax(inc_x, where=inc_x < lclw[..., None])
    lfc_t = nanmax(inc_y, where=inc_x == lfc_p[..., None])

    # EL: top-most decreasing crossing.
    el_p = nanmin(dec_x_above)
    el_t = nanmax(dec_y_above, where=dec_x_above == el_p[..., None])

    # EL existence: parcel no warmer than the environment at the top of
    # the sounding, and the EL above the LCL.
    temps_available = notnan(pt) & notnan(t)
    top_p = nanmin(pw, where=temps_available)
    at_top = pw == top_p[..., None]
    top_prof = nanmax(pt, where=at_top)
    top_env = nanmax(t, where=at_top)
    el_exists = (top_prof <= top_env) & (el_p < lclw)
    el_p = torch.where(el_exists, el_p, torch.nan)
    el_t = torch.where(el_exists, el_t, torch.nan)

    # LCL substitution rules (USAF1990).
    lfc_missing = torch.isnan(nanmax(inc_x))
    above = pw < lclw[..., None]
    pos_parcel = (above & (pt > t)).any(-1)
    no_lfc_pos_parcel = pos_parcel & lfc_missing
    exists_but_na = ~lfc_missing & torch.isnan(lfc_p)
    lfc_below_el_above = exists_but_na & (el_p < lclw)
    replace_with_lcl = no_lfc_pos_parcel | lfc_below_el_above

    extra = {}
    if intersections_in_log:
        extra = {'_lfc_log_pressure': torch.where(replace_with_lcl, lclw,
                                                  lfc_p),
                 '_el_log_pressure': el_p}
        lfc_p = safe_exp(lfc_p)
        el_p = safe_exp(el_p)
    return {
        'lfc_pressure': torch.where(replace_with_lcl, lcl_p, lfc_p),
        'lfc_temperature': torch.where(replace_with_lcl, lcl_t, lfc_t),
        'el_pressure': el_p,
        'el_temperature': el_t,
        **extra,
    }


def cape_cin_base(pressure, temperature, lfc_pressure, el_pressure,
                  parcel_temperature, pos_cape_neg_cin=True,
                  post_zero_cin=False, intersections=None,
                  log_pressure=None, log_lfc_pressure=None,
                  log_el_pressure=None):
    """CAPE and CIN from a parcel track and LFC/EL pressures.

    Every window comparison runs in log space against ``log(lfc)`` and
    ``log(el)``; ``intersections`` (a log-output crossing set of the two
    tracks), ``log_pressure``, ``log_lfc_pressure`` and ``log_el_pressure``
    skip the work of building them.  ``pos_cape_neg_cin`` (the reference's
    default) counts only positive buoyancy toward CAPE and only negative
    toward CIN; ``post_zero_cin`` clamps a positive CIN to zero (MetPy's
    convention)."""
    p, t, pt = torch.broadcast_tensors(pressure, temperature,
                                       parcel_temperature)
    log_p = log_pressure if log_pressure is not None else safe_log(p)
    lfc_lp = (tensor_like(log_lfc_pressure, p)
              if log_lfc_pressure is not None
              else safe_log(tensor_like(lfc_pressure, p)))[..., None]
    el = (tensor_like(log_el_pressure, p) if log_el_pressure is not None
          else safe_log(tensor_like(el_pressure, p)))
    # Missing EL -> top of the sounding.
    el_lp = torch.where(torch.isnan(el), nanmin(log_p), el)[..., None]

    diff = pt - t
    areas, gap_mask = trap_around_zeros(p, diff, log_x=True,
                                        intersections=intersections,
                                        log_x_values=log_p)
    area_x = areas['x']
    area = areas['area']
    t_area, t_valid = gap_areas(diff, log_p)

    def both_ends(m):
        return m[..., :-1] & m[..., 1:]

    in_cape = (log_p <= lfc_lp) & (log_p >= el_lp)
    a_cape = (area_x <= lfc_lp) & (area_x >= el_lp)
    if pos_cape_neg_cin:
        a_cape = a_cape & (area > 0)
    cape = c.Rd * select_areas(t_area, t_valid & both_ends(in_cape),
                               mask=gap_mask, only_positive=pos_cape_neg_cin)
    cape = cape + c.Rd * nansum(area, where=a_cape)

    in_cin = log_p >= lfc_lp
    a_cin = area_x >= lfc_lp
    if pos_cape_neg_cin:
        a_cin = a_cin & (area < 0)
    cin = c.Rd * select_areas(t_area, t_valid & both_ends(in_cin),
                              mask=gap_mask, only_negative=pos_cape_neg_cin)
    cin = cin + c.Rd * nansum(area, where=a_cin)
    if post_zero_cin:
        cin = torch.where(cin <= 0, cin, 0.0)
    return {'cape': cape, 'cin': cin}


def cape_cin(pressure, temperature, dewpoint, parcel_temperature,
             parcel_pressure, parcel_dewpoint,
             virtual_temperature_correction=True, lcl_interp='log',
             tables=None, moist_lapse=None, pos_cape_neg_cin=True,
             post_zero_cin=False):
    """Full CAPE/CIN: parcel profile with the LCL, LFC/EL, integration.

    Returns (cape/cin dict, profile dict merged with the LFC/EL solution).
    With ``virtual_temperature_correction`` (the reference's default) the
    LFC/EL search and the integration run on the virtual-temperature
    tracks.  ``lcl_interp``, ``tables`` and ``moist_lapse`` go to
    :func:`profile.parcel_profile_with_lcl`; ``pos_cape_neg_cin`` and
    ``post_zero_cin`` to :func:`cape_cin_base`.
    """
    profile = parcel_profile_with_lcl(
        pressure, temperature, dewpoint, parcel_pressure,
        parcel_temperature, parcel_dewpoint, lcl_interp=lcl_interp,
        tables=tables, moist_lapse=moist_lapse)
    vt = 'virtual_' if virtual_temperature_correction else ''
    parcel_track = profile[f'{vt}temperature']
    env_track = profile[f'environment_{vt}temperature']
    lcl_track_t = profile[f'lcl_{vt}temperature']

    # One crossing set, in log pressure, serves the LFC/EL selection and
    # the exact-area integration.
    pp, ptr, env = torch.broadcast_tensors(profile['pressure'], parcel_track,
                                           env_track)
    lp = safe_log(pp)
    ints = find_intersections(pp, ptr, env, log_x=True, log_x_values=lp,
                              log_outputs=True)
    sol = lfc_el(pp, ptr, env, profile['lcl_pressure'], lcl_track_t,
                 intersections=ints, log_pressure=lp,
                 intersections_in_log=True)
    res = cape_cin_base(pp, env, sol['lfc_pressure'], sol['el_pressure'],
                        ptr, pos_cape_neg_cin=pos_cape_neg_cin,
                        post_zero_cin=post_zero_cin, intersections=ints,
                        log_pressure=lp,
                        log_lfc_pressure=sol.pop('_lfc_log_pressure'),
                        log_el_pressure=sol.pop('_el_log_pressure'))
    return res, {**profile, **sol}
