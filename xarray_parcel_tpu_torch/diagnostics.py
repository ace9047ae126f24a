"""Scalar convection diagnostics.

Port of ``xarray_parcel_tpu.diagnostics``: lifted index, deep convective
index, 700-500 hPa lapse rate, isobar temperature, freezing and melting
level heights, the exact and fast wet bulb, bulk wind shear and the
significant hail parameter.

The fused pipelines' diagnostics tail (t850/td850, lapse rate and t500,
freezing and melting levels) runs on a CUDA tensor in the hand-written
kernel ``csrc/diag_tail.cu`` (:data:`diag_kernel`, the port of the JAX
package's ``benchmarks/diag_kernel_ab.py::_diag_kernel``) and on a CPU
tensor in its plain twin :func:`_diag_body`, both through the seam
(:mod:`._kernels`), whose gradient is the twin's VJP.
"""

import torch

from . import adiabat, thermo
from ._build import span
from ._kernels import Kernel
from .lcl import lcl
from .ops import find_intersections, interp_many, log_interp, nanmin, notnan

#: Order of the tail kernel's (and its twin's) output rows.
DIAG_OUTPUTS = ('t850', 'td850', 'lapse_rate_700_500', 'temp_500',
                'freezing_level', 'melting_level')


def lifted_index(profile):
    """Galway (1956) lifted index: environment minus parcel temperature at
    500 hPa, from a profile dict (``pressure``, ``temperature``,
    ``environment_temperature``)."""
    env, parcel = interp_many(
        (profile['environment_temperature'], profile['temperature']),
        profile['pressure'], 500.0, log=True)
    return {'lifted_index': env - parcel}


def deep_convective_index(pressure, temperature, dewpoint, lifted_index,
                          anchors_850=None):
    """Kunz (2009) DCI: T850C + Td850C - LI.  ``anchors_850``: optional
    precomputed ``(t850, td850)``, shared across parcel variants."""
    if anchors_850 is None:
        anchors_850 = interp_many((temperature, dewpoint), pressure, 850.0,
                                  log=True)
    t850, td850 = anchors_850
    return {'dci': (t850 - 273.15) + (td850 - 273.15) - lifted_index}


def lapse_rate(pressure, temperature, height, from_pressure=700.0,
               to_pressure=500.0, with_isobars=False):
    """Environmental lapse rate [K/km] between two pressure levels; with
    ``with_isobars`` also the interpolated (t_from, t_to)."""
    t_from, h_from = interp_many((temperature, height), pressure,
                                 from_pressure, log=True)
    t_to, h_to = interp_many((temperature, height), pressure, to_pressure,
                             log=True)
    rate = (t_to - t_from) / ((h_to - h_from) / 1000.0)
    return (rate, t_from, t_to) if with_isobars else rate


def isobar_temperature(pressure, temperature, isobar):
    """Temperature at a given pressure level (log-p interpolation)."""
    return log_interp(temperature, pressure, isobar)


def freezing_level_height(temperature, height):
    """Height [m] of the lowest 0 C crossing of the temperature."""
    zeros = torch.full_like(temperature, 273.15)
    ints = find_intersections(height, temperature, zeros)
    return nanmin(ints['all_x'])


def wet_bulb_temperature(pressure, temperature, dewpoint, tables=None,
                         moist_lapse=None):
    """Exact wet-bulb temperature by Normand's rule: every point is its own
    parcel, lifted dry to its LCL and brought moist-adiabatically back down
    to its own pressure.

    The default backend is the RK4 oracle
    :func:`adiabat.moist_lapse_integrate` (the LCL lies a short way above
    each point); ``moist_lapse=adiabat.moist_lapse`` takes the tables.
    Either way the table envelope is imposed: a state outside the curve
    family, or a pressure outside 1100-2.5 hPa, gives NaN.
    """
    ml = moist_lapse or adiabat.moist_lapse_integrate
    lcls = lcl(pressure, temperature, dewpoint)
    wb = ml(pressure, lcls['lcl_temperature'], lcls['lcl_pressure'],
            tables=tables, pointwise=True)
    fidx = adiabat.curve_index_integrate(lcls['lcl_pressure'],
                                         lcls['lcl_temperature'])
    ok = (notnan(fidx) & (pressure >= adiabat.P_BOT) &
          (pressure <= adiabat.P_TOP))
    return torch.where(ok, wb, torch.nan)


def melting_level_height(pressure, temperature, dewpoint, height, fast=True,
                         tables=None, moist_lapse=None):
    """Height of the 0 C wet-bulb isotherm: with ``fast`` the wet bulb of
    the Knox one-third rule, else :func:`wet_bulb_temperature` (with
    ``tables`` and ``moist_lapse``).  Returns (height, wet-bulb
    temperature field)."""
    if fast:
        wb = thermo.wet_bulb_temperature_fast(temperature, dewpoint)
    else:
        wb = wet_bulb_temperature(pressure, temperature, dewpoint,
                                  tables=tables, moist_lapse=moist_lapse)
    return freezing_level_height(wb, height), wb


def wind_shear(surface_wind_u, surface_wind_v, wind_u, wind_v, height,
               shear_height=6000.0):
    """Bulk shear between the surface wind and the wind interpolated at
    ``shear_height``: shear_u, shear_v, shear_magnitude, positive_shear."""
    high_u, high_v = interp_many((wind_u, wind_v), height, shear_height)
    shear_u = high_u - surface_wind_u
    shear_v = high_v - surface_wind_v
    high_mag = torch.sqrt(high_u ** 2 + high_v ** 2)
    surf_mag = torch.sqrt(surface_wind_u ** 2 + surface_wind_v ** 2)
    return {
        'shear_u': shear_u,
        'shear_v': shear_v,
        'shear_magnitude': torch.sqrt(shear_u ** 2 + shear_v ** 2),
        'positive_shear': high_mag > surf_mag,
    }


def significant_hail_parameter(mucape, mixing_ratio, lapse, temp_500, shear,
                               flh):
    """SPC significant hail parameter with its published validity windows
    (shear 7-27 m/s, mixing ratio 11-13.6 g/kg) and correction factors."""
    mixing_ratio = mixing_ratio * 1e3          # kg/kg -> g/kg
    lapse = -lapse                             # positive lapse rates
    temp_500 = temp_500 - 273.15               # K -> C

    shear = torch.where((shear >= 7.0) & (shear <= 27.0), shear, torch.nan)
    mixing_ratio = torch.where((mixing_ratio >= 11.0) &
                               (mixing_ratio <= 13.6), mixing_ratio,
                               torch.nan)
    temp_500 = torch.where(temp_500 <= -5.5, temp_500, -5.5)

    ship = mucape * mixing_ratio * lapse * -temp_500 * shear / 42000000.0

    ship = torch.where(mucape >= 1300.0, ship, ship * (mucape / 1300.0))
    ship = torch.where(lapse >= 5.8, ship, ship * (lapse / 5.8))
    ship = torch.where(flh >= 2400.0, ship, ship * (flh / 2400.0))
    return ship


# --- the diagnostics tail: kernel and plain twin ------------------------------

def _diag_body(p, t, td, h):
    """The diagnostics tail on (B, L) tensors (the tail kernel's plain
    twin): the same four calls as the JAX package's ``_diag_body``.
    Returns the (B,) outputs in :data:`DIAG_OUTPUTS` order."""
    t850, td850 = interp_many((t, td), p, 850.0, log=True)
    lapse, _, t500 = lapse_rate(p, t, h, with_isobars=True)
    flh = freezing_level_height(t, h)
    mlh, _ = melting_level_height(p, t, td, h)
    return t850, td850, lapse, t500, flh, mlh


def _diag_block(p, t, td, h):
    """:func:`_diag_body` as the (6, B) block the kernel returns."""
    return torch.stack(_diag_body(p, t, td, h))


def _diag_on_card(launch, p, t, td, h):
    """:data:`diag_kernel` on CUDA tensors: the library's
    ``diag_tail_<dtype>``."""
    ins = (p, t, td, h)
    if p.dim() != 2 or any(x.shape != p.shape for x in ins):
        raise ValueError('kernel inputs must be (B, L) of one shape')
    B, L = p.shape
    ins = [x.contiguous() for x in ins]
    out = torch.empty((len(DIAG_OUTPUTS), B), dtype=p.dtype, device=p.device)
    if B > 0:
        launch('diag_tail', [*(x.data_ptr() for x in ins), out.data_ptr()],
               B, L)
    return out


#: The diagnostics tail on (B, L) pressure, temperature, dewpoint and
#: height of one float dtype.  Returns the (6, B) block in
#: :data:`DIAG_OUTPUTS` order.  CUDA tensors go to the hand-written kernel
#: (``diag_kernel.launches`` counts each launch), CPU tensors to the plain
#: twin; every input takes a gradient, through the twin's VJP.
diag_kernel = Kernel('diagnostics-tail', _diag_block, _diag_on_card,
                     differentiable=range(4))


def diag_fused(p, t, td, h):
    """The diagnostics tail for (…, L) columns of any batch shape, through
    :data:`diag_kernel`.  Returns the six (…) outputs in
    :data:`DIAG_OUTPUTS` order."""
    p, t, td, h = torch.broadcast_tensors(p, t, td, h)
    batch, L = p.shape[:-1], p.shape[-1]
    flat = [x.reshape(-1, L) for x in (p, t, td, h)]
    with span('xparcel.kernel.tail'):
        out = diag_kernel(*flat)
    return tuple(v.reshape(batch) for v in out)
