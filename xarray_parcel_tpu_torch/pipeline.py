"""The convection-diagnostics pipelines and the storm proxies.

Port of ``xarray_parcel_tpu.pipeline``.  Inputs are a dict of tensors with
the reference's variable names: ``pressure``, ``temperature``,
``specific_humidity``, ``height_asl`` (…, L), ``surface_wind_u``/
``surface_wind_v`` (…) and ``wind_u``/``wind_v``/
``wind_height_above_surface`` (…, Lw).

The modular pipelines ``conv_properties`` and ``min_conv_properties``
build every parcel profile (``cape.cape_cin``) and are plain torch on
either device, but for the mixed layers' neighbour scans
(``parcels.bridge_neighbors``) and the most-unstable prep
(``parcels.from_most_unstable_parcel``), which run in the
``csrc/neighbors.cu`` and ``csrc/most_unstable.cu`` kernels on CUDA
tensors.  In the fused ones, ``conv_properties_fused`` and
``min_conv_properties_fused``, the mixed layers of a call run on CUDA
tensors in one launch of the ``csrc/mix_layer.cu`` kernel
(``parcels.mix_layers``; with ``mix_grow``, the modular path's code), the
most-unstable prep in one of ``csrc/most_unstable.cu``, each CAPE/CIN
solve in the ``csrc/prepass.cu`` and ``csrc/fused_cape.cu`` kernels and
the diagnostics tail (t850/td850, lapse rate and t500, freezing and
melting levels) in the ``csrc/diag_tail.cu`` kernel, once per call.
"""

import torch

from . import diagnostics as diag
from . import thermo
from ._build import span
from .fieldset import annotate
from .fused import fused_cape_cin
from .ops import interp_many
from .parcels import (bridge_neighbors, conserved_fields,
                      from_most_unstable_parcel, mix_layer, mix_layers,
                      mixed_layer_cape_cin, most_unstable_cape_cin)


def _prefix(d, prefix):
    return {f'{prefix}_{k}': v for k, v in d.items()}


def _dewpoint_and_valid(dat):
    """(p, t, dewpoint from q, valid-column mask)."""
    p = dat['pressure']
    t = dat['temperature']
    q = dat['specific_humidity']
    with span('xparcel.prep.dewpoint'):
        dew = thermo.dewpoint_from_specific_humidity(p, t, q)
        valid = ~(torch.isnan(dew).any(-1) | torch.isnan(p).any(-1) |
                  torch.isnan(t).any(-1) | torch.isnan(q).any(-1))
    return p, t, dew, valid


def _mask_invalid(out, valid):
    """NaN (booleans False) in every column outside ``valid``."""
    for k, v in out.items():
        fill = False if v.dtype == torch.bool else torch.nan
        out[k] = torch.where(valid, v, fill)
    return out


def conv_properties(dat, ignore_nans=False, tables=None, moist_lapse=None,
                    with_attrs=False):
    """The full ~20-variable diagnostics set on the modular path: CAPE/CIN
    of the most-unstable (250 hPa), mixed-100 and mixed-50 parcels from
    their profiles, the lifted index of each profile and its DCI, the
    most-unstable mixing ratio, 700-500 hPa lapse rate, 500 hPa
    temperature, freezing/melting level heights and 0-6 km shear.

    ``tables``/``moist_lapse`` select the lifting backend of every profile
    (:func:`profile.parcel_profile`).  Unless ``ignore_nans``, every output
    is NaN (booleans False) in a column where any input level is NaN.
    ``with_attrs`` returns a :class:`fieldset.FieldSet` (the same dict, with
    ``long_name``/``units`` attrs per variable).
    """
    kw = dict(tables=tables, moist_lapse=moist_lapse)
    p, t, dew, valid = _dewpoint_and_valid(dat)

    mu_cc, mu_prof, mu_parcel = most_unstable_cape_cin(p, t, dew,
                                                       depth=250.0, **kw)
    cons = conserved_fields(p, t, dew)
    nbrs = bridge_neighbors(p, ~(torch.isnan(p) | torch.isnan(t) |
                                 torch.isnan(dew)))
    m100_cc, m100_prof, _ = mixed_layer_cape_cin(
        p, t, dew, depth=100.0, neighbors=nbrs, conserved=cons, **kw)
    m50_cc, m50_prof, _ = mixed_layer_cape_cin(
        p, t, dew, depth=50.0, neighbors=nbrs, conserved=cons, **kw)
    li = {name: diag.lifted_index(prof)['lifted_index']
          for name, prof in (('mu', mu_prof), ('mixed_100', m100_prof),
                             ('mixed_50', m50_prof))}
    del mu_prof, m100_prof, m50_prof

    anchors_850 = interp_many((t, dew), p, 850.0, log=True)
    mu_mixing_ratio = thermo.mixing_ratio_from_specific_humidity(
        thermo.specific_humidity_from_dewpoint(mu_parcel['pressure'],
                                               mu_parcel['dewpoint']))
    height = dat['height_asl']
    lapse, _, temp_500 = diag.lapse_rate(p, t, height, with_isobars=True)

    out = {**_prefix(mu_cc, 'mu'), 'mu_mixing_ratio': mu_mixing_ratio,
           **_prefix(m100_cc, 'mixed_100'), **_prefix(m50_cc, 'mixed_50')}
    out.update({f'{name}_lifted_index': v for name, v in li.items()})
    out.update({f'{name}_dci': diag.deep_convective_index(
        p, t, dew, v, anchors_850=anchors_850)['dci']
        for name, v in li.items()})
    out['lapse_rate_700_500'] = lapse
    out['temp_500'] = temp_500
    out['freezing_level'] = diag.freezing_level_height(t, height)
    out['melting_level'] = diag.melting_level_height(p, t, dew, height)[0]
    out.update(_shear(dat))
    if not ignore_nans:
        out = _mask_invalid(out, valid)
    return annotate(out) if with_attrs else out


def min_conv_properties(dat, tables=None, moist_lapse=None,
                        with_attrs=False):
    """The reduced diagnostics set on the modular path: mixed-100 CAPE/CIN
    and lifted index, 700-500 hPa lapse rate, 500 hPa temperature,
    freezing/melting level heights and 0-6 km shear.  As in the JAX
    package, no valid-column mask: NaN levels propagate through each
    output's own NaN rules.  ``with_attrs`` as in :func:`conv_properties`."""
    p, t = dat['pressure'], dat['temperature']
    dew = thermo.dewpoint_from_specific_humidity(p, t,
                                                 dat['specific_humidity'])
    m100_cc, m100_prof, _ = mixed_layer_cape_cin(
        p, t, dew, depth=100.0, tables=tables, moist_lapse=moist_lapse)
    out = _prefix(m100_cc, 'mixed_100')
    out['mixed_100_lifted_index'] = diag.lifted_index(m100_prof)[
        'lifted_index']
    height = dat['height_asl']
    lapse, _, temp_500 = diag.lapse_rate(p, t, height, with_isobars=True)
    out['lapse_rate_700_500'] = lapse
    out['temp_500'] = temp_500
    out['freezing_level'] = diag.freezing_level_height(t, height)
    out['melting_level'] = diag.melting_level_height(p, t, dew, height)[0]
    out.update(_shear(dat))
    return annotate(out) if with_attrs else out


def _fused_solve(fields, parcel, tables):
    """One fused CAPE/CIN solve, with the lifted index from inside the
    solve, for an arbitrary parcel."""
    res, _ = fused_cape_cin(
        fields['pressure'], fields['temperature'], fields['dewpoint'],
        parcel_pressure=parcel['pressure'],
        parcel_temperature=parcel['temperature'],
        parcel_dewpoint=parcel['dewpoint'],
        tables=tables, with_lifted_index=True)
    return res


def _shear(dat):
    return diag.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                           dat['wind_u'], dat['wind_v'],
                           dat['wind_height_above_surface'],
                           shear_height=6000.0)


def conv_properties_fused(dat, ignore_nans=False, tables=None,
                          with_attrs=False, mix_grow=False):
    """The full ~20-variable diagnostics set for every column: CAPE/CIN,
    lifted index and DCI of the most-unstable, mixed-100 and mixed-50
    parcels, the most-unstable mixing ratio, 700-500 hPa lapse rate, 500 hPa
    temperature, freezing/melting level heights and 0-6 km shear.

    Three fused CAPE/CIN solves and one diagnostics tail run per call; the
    lifted index comes from inside each solve.  Unless ``ignore_nans``,
    every output is NaN (booleans False) in a column where any input level
    is NaN.  ``mix_grow`` splices the mixed parcels in as an extra level
    (``mix_layer(grow=True)``, L+1 levels) instead of the default slot
    write: the same profile, at the cost of the splice.  ``with_attrs``
    as in :func:`conv_properties`.
    """
    with span('xparcel.pipeline'):
        p, t, dew, valid = _dewpoint_and_valid(dat)

        mu_fields, mu_parcel = from_most_unstable_parcel(p, t, dew,
                                                         depth=250.0)
        mu = _fused_solve(mu_fields, mu_parcel, tables)
        if mix_grow:
            cons = conserved_fields(p, t, dew)
            nbrs = bridge_neighbors(p, ~(torch.isnan(p) | torch.isnan(t) |
                                         torch.isnan(dew)))
            mixed = [mix_layer(p, t, dew, depth=depth, conserved=cons,
                               neighbors=nbrs)
                     for depth in (100.0, 50.0)]
        else:
            mixed = mix_layers(p, t, dew, (100.0, 50.0))
        (m100_fields, m100_parcel), (m50_fields, m50_parcel) = mixed
        m100 = _fused_solve(m100_fields, m100_parcel, tables)
        m50 = _fused_solve(m50_fields, m50_parcel, tables)

        t850, td850, lapse, temp_500, flh, mlh = diag.diag_fused(
            p, t, dew, dat['height_asl'])

        def dci(li):
            return diag.deep_convective_index(
                p, t, dew, li, anchors_850=(t850, td850))['dci']

        with span('xparcel.pipeline.outputs'):
            mu_mixing_ratio = thermo.mixing_ratio_from_specific_humidity(
                thermo.specific_humidity_from_dewpoint(
                    mu_parcel['pressure'], mu_parcel['dewpoint']))
            out = {
                'mu_cape': mu['cape'], 'mu_cin': mu['cin'],
                'mu_mixing_ratio': mu_mixing_ratio,
                'mixed_100_cape': m100['cape'], 'mixed_100_cin': m100['cin'],
                'mixed_50_cape': m50['cape'], 'mixed_50_cin': m50['cin'],
                'mu_lifted_index': mu['lifted_index'],
                'mixed_100_lifted_index': m100['lifted_index'],
                'mixed_50_lifted_index': m50['lifted_index'],
                'mu_dci': dci(mu['lifted_index']),
                'mixed_100_dci': dci(m100['lifted_index']),
                'mixed_50_dci': dci(m50['lifted_index']),
                'lapse_rate_700_500': lapse,
                'temp_500': temp_500,
                'freezing_level': flh,
                'melting_level': mlh,
            }
            out.update(_shear(dat))
            if not ignore_nans:
                out = _mask_invalid(out, valid)
    return annotate(out) if with_attrs else out


def min_conv_properties_fused(dat, tables=None, with_attrs=False):
    """The reduced diagnostics set: mixed-100 CAPE/CIN and lifted index,
    700-500 hPa lapse rate, 500 hPa temperature, freezing/melting level
    heights and 0-6 km shear.

    One fused CAPE/CIN solve and one diagnostics tail run per call.  As in
    the JAX package, there is no valid-column mask: NaN levels propagate
    through each output's own NaN rules.  ``with_attrs`` as in
    :func:`conv_properties`.
    """
    with span('xparcel.pipeline'):
        p = dat['pressure']
        t = dat['temperature']
        q = dat['specific_humidity']
        with span('xparcel.prep.dewpoint'):
            dew = thermo.dewpoint_from_specific_humidity(p, t, q)

        (m100_fields, m100_parcel), = mix_layers(p, t, dew, (100.0,))
        res = _fused_solve(m100_fields, m100_parcel, tables)
        _, _, lapse, temp_500, flh, mlh = diag.diag_fused(
            p, t, dew, dat['height_asl'])
        with span('xparcel.pipeline.outputs'):
            out = {'mixed_100_cape': res['cape'],
                   'mixed_100_cin': res['cin'],
                   'mixed_100_lifted_index': res['lifted_index'],
                   'lapse_rate_700_500': lapse, 'temp_500': temp_500,
                   'freezing_level': flh, 'melting_level': mlh}
            out.update(_shear(dat))
    return annotate(out) if with_attrs else out


#: The ``conv_properties_fused`` outputs that :func:`storm_proxies` reads.
STORM_PROXY_INPUTS = (
    'mu_cape', 'mu_mixing_ratio', 'mixed_100_cape', 'mixed_100_cin',
    'mixed_100_lifted_index', 'mixed_100_dci', 'mixed_50_cape',
    'mixed_50_cin', 'lapse_rate_700_500', 'temp_500', 'freezing_level',
    'shear_magnitude', 'positive_shear')


def storm_proxies(dat, with_attrs=False):
    """Literature storm-proxy booleans and the significant hail parameter
    from a ``conv_properties_fused`` output dict (the keys read are
    :data:`STORM_PROXY_INPUTS`).  ``with_attrs`` as in
    :func:`conv_properties`."""
    s06 = dat['shear_magnitude']
    m100 = torch.where(dat['mixed_100_cape'] >= 0, dat['mixed_100_cape'],
                       torch.nan)
    m50 = torch.where(dat['mixed_50_cape'] >= 0, dat['mixed_50_cape'],
                      torch.nan)
    mu = torch.where(dat['mu_cape'] >= 0, dat['mu_cape'], torch.nan)

    out = {}
    out['proxy_Craven2004'] = (m100 * s06) >= 20000.0
    out['proxy_Kunz2007'] = ((dat['mixed_100_lifted_index'] <= -2.07) |
                             (mu >= 1474.0) |
                             (dat['mixed_100_dci'] >= 25.7))
    out['proxy_Trapp2007'] = ((m100 * s06 >= 10000.0) & (m100 >= 100.0) &
                              (s06 >= 5.0) & dat['positive_shear'])
    out['proxy_Marsh2009'] = (m100 * s06) >= 10000.0
    out['proxy_Allen2011'] = m50 * s06 ** 1.67 >= 25000.0
    out['proxy_Allen2014'] = (out['proxy_Allen2011'] &
                              (dat['mixed_50_cin'] > -25.0) &
                              (s06 > 7.5) &
                              (dat['lapse_rate_700_500'] < -6.5))
    out['proxy_Eccel2012'] = ((m100 * s06 > 10000.0) &
                              (dat['mixed_100_cin'] > -50.0))
    out['proxy_Mohr2013'] = ((dat['mixed_100_lifted_index'] <= -1.6) |
                             (m100 >= 439.0) |
                             (dat['mixed_100_dci'] >= 26.4))
    ship = diag.significant_hail_parameter(
        mucape=mu, mixing_ratio=dat['mu_mixing_ratio'],
        lapse=dat['lapse_rate_700_500'], temp_500=dat['temp_500'],
        shear=s06, flh=dat['freezing_level'])
    out['ship'] = ship
    out['proxy_SHIP_0.1'] = ship > 0.1
    return annotate(out) if with_attrs else out
