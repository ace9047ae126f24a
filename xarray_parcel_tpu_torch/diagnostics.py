"""Scalar convection diagnostics read by the fused pipelines.

Port of the matching functions of ``xarray_parcel_tpu.diagnostics``: lifted
index, deep convective index, 700-500 hPa lapse rate, freezing and (fast)
melting level heights, bulk wind shear and the significant hail parameter.

The pipelines' diagnostics tail (t850/td850, lapse rate and t500, freezing
and melting levels) runs on a CUDA tensor in the hand-written kernel
``csrc/diag_tail.cu`` (:func:`diag_kernel`, the port of the JAX package's
``benchmarks/diag_kernel_ab.py::_diag_kernel``) and on a CPU tensor in its
plain twin :func:`_diag_body`.
"""

import torch

from . import thermo
from ._build import launch
from .ops import find_intersections, interp_many, nanmin

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


def freezing_level_height(temperature, height):
    """Height [m] of the lowest 0 C crossing of the temperature."""
    zeros = torch.full_like(temperature, 273.15)
    ints = find_intersections(height, temperature, zeros)
    return nanmin(ints['all_x'])


def melting_level_height(pressure, temperature, dewpoint, height):
    """Height of the 0 C wet-bulb isotherm with the Knox one-third rule
    (``fast=True``).  Returns (height, wet-bulb temperature field)."""
    wb = thermo.wet_bulb_temperature_fast(temperature, dewpoint)
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


def diag_kernel(p, t, td, h):
    """The diagnostics tail on (B, L) pressure, temperature, dewpoint and
    height of one float dtype.  Returns the (6, B) block in
    :data:`DIAG_OUTPUTS` order.

    CUDA tensors go to the hand-written kernel (``diag_kernel.launches``
    counts each launch); CPU tensors go to the plain twin.
    """
    if p.device.type == 'cpu':
        return torch.stack(_diag_body(p, t, td, h))
    if p.device.type != 'cuda':
        raise ValueError(f'no diagnostics-tail kernel for device {p.device}')
    if p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'kernel takes float32 or float64, not {p.dtype}')
    ins = (p, t, td, h)
    for x in ins:
        if x.dtype != p.dtype or x.device != p.device:
            raise TypeError('kernel inputs must share dtype and device')
    if p.dim() != 2 or any(x.shape != p.shape for x in ins):
        raise ValueError('kernel inputs must be (B, L) of one shape')
    B, L = p.shape
    ins = [x.contiguous() for x in ins]
    out = torch.empty((len(DIAG_OUTPUTS), B), dtype=p.dtype, device=p.device)
    if B > 0:
        suffix = 'f32' if p.dtype == torch.float32 else 'f64'
        launch(f'diag_tail_{suffix}', p.device,
               [*(x.data_ptr() for x in ins), out.data_ptr()], B, L)
        diag_kernel.launches += 1
    return out


diag_kernel.launches = 0


def diag_fused(p, t, td, h):
    """The diagnostics tail for (…, L) columns of any batch shape, through
    :func:`diag_kernel`.  Returns the six (…) outputs in
    :data:`DIAG_OUTPUTS` order."""
    p, t, td, h = torch.broadcast_tensors(p, t, td, h)
    batch, L = p.shape[:-1], p.shape[-1]
    out = diag_kernel(*(x.reshape(-1, L) for x in (p, t, td, h)))
    return tuple(v.reshape(batch) for v in out)
