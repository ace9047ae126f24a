"""The one generator of the benchmark's input fields, driven by a
configuration's parameters.

From a seed and a time step it makes, on the given device and in a few
large calls, a grid of soundings as a deployment holds them: a smooth
surface (pressure, temperature, moisture, wind), each column's
temperature from its own lapse rate, tropopause and capping inversion,
moisture from its own boundary-layer depth and drying aloft, hydrostatic
heights and sheared winds.  Every horizontal field is smooth (coarse noise
interpolated onto the grid), as model fields are; a little level noise
gives the profiles the several parcel-environment crossings that real
soundings have.

Pressure is either terrain-following (each column's levels a fixed share
of its own surface pressure, level dim leading in the host layout) or
isobaric (one 1-D set of levels; with ``below_ground_nan`` every level
below a column's surface is NaN in every level variable).

Returns float32 tensors: the level variables (ny, nx, L), pressure
(ny, nx, L) or (L,), surface winds (ny, nx), and the surface pressure
(ny, nx) beside them for the tests.
"""

import math

import torch
import torch.nn.functional as F

G = 9.80665                     # m s-2
RD = 287.04749097718457         # J kg-1 K-1 (the program's MetPy value)
EPS = 0.6219569100577033

#: Distinct time steps a run holds and calls in turn, so that a cache keyed
#: on input identity cannot show a gain.
TIME_STEPS = 2

LEVEL_VARS = ('pressure', 'temperature', 'specific_humidity', 'height_asl',
              'wind_u', 'wind_v', 'wind_height_above_surface')
SURFACE_VARS = ('surface_wind_u', 'surface_wind_v')


def step_seed(seed, step):
    """The generator seed of time step ``step`` of run seed ``seed``."""
    return (int(seed) * 1_000_003 + int(step)) % (2 ** 63)


class _Smooth:
    """Smooth random horizontal fields from one seeded generator."""

    def __init__(self, seed, grid, coarse, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.grid, self.coarse, self.device = tuple(grid), coarse, device

    def uniform(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=torch.float64)

    def field(self, lo, hi, coarse=None):
        """A smooth field on the grid spanning about [lo, hi]."""
        cy, cx = coarse or self.coarse
        noise = self.uniform((1, 1, cy, cx))
        f = F.interpolate(noise, size=self.grid, mode='bicubic',
                          align_corners=True)[0, 0]
        return lo + (hi - lo) * f.clamp(0.0, 1.0)

    def level_noise(self, shape, sd):
        return sd * torch.randn(shape, generator=self.gen, device=self.device,
                                dtype=torch.float64)


def _levels(cfg, ps):
    """(ny, nx, L) float64 pressures: terrain-following from each column's
    surface pressure, or the configuration's isobaric levels."""
    if cfg['pressure'] == 'terrain_following':
        L = cfg['levels']
        x = (torch.arange(L, dtype=torch.float64, device=ps.device) + 0.5) / (
            L - 0.5)
        sigma = 1.0 - (1.0 - cfg['sigma_top']) * x ** cfg['sigma_power']
        return ps[..., None] * sigma
    levels = torch.tensor(cfg['pressure_levels'], dtype=torch.float64,
                          device=ps.device)
    return levels.expand(ps.shape + levels.shape)


def _temperature(sm, cfg, p, ps, ts):
    """Environment temperature: a lapse-rate atmosphere from the surface
    up to a tropopause, warming above 100 hPa, a capping inversion in some
    columns and a little level noise."""
    prof = cfg['profiles']
    gamma = sm.field(*prof['lapse_rate_k_per_km']) / 1000.0
    t_trop = sm.field(*prof['tropopause_k'])
    t = ts[..., None] * (p / ps[..., None]) ** (RD * gamma[..., None] / G)
    t = torch.maximum(t, t_trop[..., None])
    strat = torch.clamp(torch.log(100.0 / p) / math.log(100.0 / 3.0), 0.0,
                        1.0)
    t = t + prof['stratosphere_warming_k'] * strat
    cap = torch.clamp(sm.field(*prof['cap_k']), min=0.0)
    cap_p = ps - sm.field(*prof['cap_depth_hpa'])
    t = t + cap[..., None] * torch.exp(
        -((p - cap_p[..., None]) / prof['cap_width_hpa']) ** 2)
    return t + sm.level_noise(p.shape, prof['level_noise_k'])


def _dewpoint(sm, cfg, p, ps, t):
    """Dewpoint: the surface depression through a boundary layer of its
    own depth, then drying aloft, never above the temperature."""
    prof = cfg['profiles']
    dd = sm.field(*prof['surface_depression_k'])
    bl = sm.field(*prof['boundary_layer_hpa'])
    dry = sm.field(*prof['drying_k_per_100hpa'])
    above = torch.clamp(ps[..., None] - bl[..., None] - p, min=0.0) / 100.0
    dep = dd[..., None] + dry[..., None] * above
    dep = torch.clamp(dep + sm.level_noise(p.shape, 0.3).abs(), 0.1,
                      prof['max_depression_k'])
    return t - dep


def _specific_humidity(p, td):
    e = 6.112 * torch.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = EPS * e / (p - e)
    return w / (1.0 + w)


def _heights(p, ps, zs, t, q):
    """Hydrostatic heights above sea level from the surface up, on the
    layer-mean virtual temperature."""
    tv = t * (1.0 + 0.608 * q / (1.0 - q))
    tv_lo = torch.cat([tv[..., :1], tv[..., :-1]], -1)
    p_lo = torch.cat([ps[..., None], p[..., :-1]], -1)
    dz = RD / G * 0.5 * (tv + tv_lo) * torch.log(p_lo / p)
    return zs[..., None] + torch.cumsum(dz, -1)


def make_fields(cfg, seed, step, device):
    """The input fields of one time step (see the module docstring)."""
    grid = tuple(cfg['grid'])
    sm = _Smooth(step_seed(seed, step), grid, tuple(cfg['coarse_grid']),
                 device)
    surf = cfg['surface']
    lo, hi = surf['orography_m']
    # Land where the field is positive, its heights skewed low by a power
    # (few high plateaus, as on Earth).
    zs = hi * (torch.clamp(sm.field(lo, hi), min=0.0) / hi) ** surf.get(
        'orography_power', 1.0)
    ps = sm.field(*surf['sea_level_pressure_hpa']) * torch.exp(
        -zs / surf['scale_height_m'])
    ts = sm.field(*surf['sea_level_temperature_k'])
    if 'pole_cooling_k' in surf:
        lat = torch.linspace(math.radians(cfg['latitude'][0]),
                             math.radians(cfg['latitude'][1]), grid[0],
                             dtype=torch.float64, device=device)
        cooling = torch.sin(lat).abs() ** surf['pole_cooling_power']
        ts = ts - surf['pole_cooling_k'] * cooling[:, None]
    ts = ts - 0.0065 * zs

    p = _levels(cfg, ps)
    t = _temperature(sm, cfg, p, ps, ts)
    q = _specific_humidity(p, _dewpoint(sm, cfg, p, ps, t))
    z = _heights(p, ps, zs, t, q)
    agl = z - zs[..., None]

    wind = cfg['wind']
    us = sm.field(*wind['surface_m_per_s'])
    vs = sm.field(*wind['surface_m_per_s'])
    shear = sm.field(*wind['shear_6km_m_per_s'])
    turn = sm.field(0.0, 2.0 * math.pi)
    frac = torch.clamp(agl, 0.0, 12000.0) / 6000.0
    u = us[..., None] + (shear * torch.cos(turn))[..., None] * frac
    v = vs[..., None] + (shear * torch.sin(turn))[..., None] * frac
    u = u + sm.level_noise(p.shape, wind['level_noise_m_per_s'])
    v = v + sm.level_noise(p.shape, wind['level_noise_m_per_s'])

    out = {'temperature': t, 'specific_humidity': q, 'height_asl': z,
           'wind_u': u, 'wind_v': v, 'wind_height_above_surface': agl}
    if cfg.get('below_ground_nan'):
        below = p > ps[..., None]
        out = {k: torch.where(below, torch.nan, v) for k, v in out.items()}
    out['pressure'] = p if cfg['pressure'] == 'terrain_following' else p[
        0, 0]
    out = {k: v.to(torch.float32).contiguous() for k, v in out.items()}
    out['surface_wind_u'] = us.to(torch.float32)
    out['surface_wind_v'] = vs.to(torch.float32)
    out['surface_pressure'] = ps.to(torch.float32)
    return out
