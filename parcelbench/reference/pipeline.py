"""The reference full diagnostics set: what ``conv_properties_fused``
returns, worked out with the plain modular path.

Every parcel's profile is built whole (the LCL spliced in), lifted along
its own integrated pseudoadiabat (:mod:`.adiabat`), and its CAPE/CIN, LFC
and EL found on that profile; the most-unstable parcel comes from the
lowest 250 hPa, the mixed parcels from the lowest 100 and 50 hPa, spliced
in as an extra level.  The tail diagnostics are the plain functions of
:mod:`.diagnostics`.  Unless ``ignore_nans``, every output is NaN
(booleans False) in a column where any input level is NaN.
"""

import torch

from . import adiabat, diagnostics as diag, thermo
from .ops import interp_many
from .parcels import (bridge_neighbors, conserved_fields,
                      mixed_layer_cape_cin, most_unstable_cape_cin)

#: The outputs, in the program's order.
OUTPUTS = ('mu_cape', 'mu_cin', 'mu_mixing_ratio', 'mixed_100_cape',
           'mixed_100_cin', 'mixed_50_cape', 'mixed_50_cin',
           'mu_lifted_index', 'mixed_100_lifted_index',
           'mixed_50_lifted_index', 'mu_dci', 'mixed_100_dci',
           'mixed_50_dci', 'lapse_rate_700_500', 'temp_500',
           'freezing_level', 'melting_level', 'shear_u', 'shear_v',
           'shear_magnitude', 'positive_shear')


def conv_properties(dat, ignore_nans=False):
    """The full diagnostics set of (B, L) columns ``dat`` (the program's
    input names), as a dict of (B,) tensors keyed as :data:`OUTPUTS`."""
    p, t = dat['pressure'], dat['temperature']
    dew = thermo.dewpoint_from_specific_humidity(p, t,
                                                 dat['specific_humidity'])
    valid = ~(torch.isnan(dew).any(-1) | torch.isnan(p).any(-1) |
              torch.isnan(t).any(-1) |
              torch.isnan(dat['specific_humidity']).any(-1))
    kw = dict(moist_lapse=adiabat.moist_lapse)

    mu_cc, mu_prof, mu_parcel = most_unstable_cape_cin(p, t, dew,
                                                       depth=250.0, **kw)
    cons = conserved_fields(p, t, dew)
    nbrs = bridge_neighbors(p, ~(torch.isnan(p) | torch.isnan(t) |
                                 torch.isnan(dew)))
    m100_cc, m100_prof, _ = mixed_layer_cape_cin(
        p, t, dew, depth=100.0, neighbors=nbrs, conserved=cons, **kw)
    m50_cc, m50_prof, _ = mixed_layer_cape_cin(
        p, t, dew, depth=50.0, neighbors=nbrs, conserved=cons, **kw)

    t850, td850 = interp_many((t, dew), p, 850.0, log=True)
    height = dat['height_asl']
    lapse, temp_500 = diag.lapse_rate(p, t, height)
    out = {
        'mu_cape': mu_cc['cape'], 'mu_cin': mu_cc['cin'],
        'mu_mixing_ratio': thermo.mixing_ratio_from_specific_humidity(
            thermo.specific_humidity_from_dewpoint(mu_parcel['pressure'],
                                                   mu_parcel['dewpoint'])),
        'mixed_100_cape': m100_cc['cape'], 'mixed_100_cin': m100_cc['cin'],
        'mixed_50_cape': m50_cc['cape'], 'mixed_50_cin': m50_cc['cin'],
    }
    for name, prof in (('mu', mu_prof), ('mixed_100', m100_prof),
                       ('mixed_50', m50_prof)):
        li = diag.lifted_index(prof)
        out[f'{name}_lifted_index'] = li
        out[f'{name}_dci'] = diag.deep_convective_index(t850, td850, li)
    out['lapse_rate_700_500'] = lapse
    out['temp_500'] = temp_500
    out['freezing_level'] = diag.freezing_level_height(t, height)
    out['melting_level'] = diag.melting_level_height(t, dew, height)
    out.update(diag.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                               dat['wind_u'], dat['wind_v'],
                               dat['wind_height_above_surface']))
    if not ignore_nans:
        for k, v in out.items():
            out[k] = torch.where(valid, v,
                                 False if v.dtype == torch.bool else torch.nan)
    return {k: out[k] for k in OUTPUTS}


def conv_properties_blocks(dat, ignore_nans=False, block=8192):
    """:func:`conv_properties` over blocks of ``block`` columns, so that
    the whole profiles of a large sample fit beside what is on the device;
    the same result."""
    n = next(iter(dat.values())).shape[0]
    parts = [conv_properties({k: v[i:i + block] for k, v in dat.items()},
                             ignore_nans=ignore_nans)
             for i in range(0, n, block)]
    return {k: torch.cat([part[k] for part in parts]) for k in OUTPUTS}
