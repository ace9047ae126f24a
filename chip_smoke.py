"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``xarray_parcel_tpu_torch/csrc`` with
``nvcc`` (the CAPE/CIN solve ``fused_cape.cu``, the diagnostics tail
``diag_tail.cu``, the solve's pre-pass ``prepass.cu``, the neighbours
``neighbors.cu``, the mixed layers ``mix_layer.cu`` and the most-unstable
prep ``most_unstable.cu``; ptxas's registers and spills are printed),
builds the moist-adiabat coefficients on the card, holds the solve and the
tail against their plain PyTorch twins (float64 and float32 on hard
columns of 90 levels, and of 33 and 137 levels with the hard cases across
the lanes 31/32 and 63/64 of the warp that strides over a column; the
solve also with its profile tracks), the pre-pass through the solve's
arguments, then times the first three at the main path's shape against
their bound and holds the timed outputs against each other there.  The neighbours
kernel is held to its twin bit for bit at the three device cells' shapes
and timed there beside the twin, the two library scans alone and its
bound.  The mixed-layer kernel is held to its twin (the fields bit for
bit, the parcels within ``MIX_TOL``) on hard rows in both dtypes and at
the three device cells' shapes on each cell's own columns (``parcelbench``'s
generator), timed there beside the twin and its bound.  The most-unstable
kernel is held to its twin bit for bit on hard rows of 1 to 137 levels in
both dtypes at both depths and at the three cells' shapes on their own
columns, timed there beside the twin and its bound; and each cell's
pipeline call is split into card time by the span that launched each
kernel, with the most-unstable kernel and with its twin in its place.
Then it drives the public entry points -- ``fused_surface_cape_cin``,
``conv_properties_fused``, ``min_conv_properties_fused`` and
``storm_proxies`` -- at 786,432
columns x 90 levels in float32, counts each path's kernel launches and
checks the outputs against the plain path on the CPU.  The modular
pipelines ``conv_properties`` and ``min_conv_properties`` run at the same
size (plain torch but the neighbours kernel), every column held against
the fused pipelines, with their rates and peak memory (phase 6).
Gradients through the kernels' ``autograd.Function``s are held against the
CPU twins' and central differences, and a forward plus backward of the
surface solve is timed (phase 7).  Then the surfaces a user calls: the
solve's four options, kernel against twin for each of six settings (phase
8);
``load_moist_adiabat_lookups(regenerate=True)`` on the card, its
coefficients against ``build_spectral``'s and ``moist_lapse``'s table modes
against the exact integrator (phase 9); a Dataset of 786,432 columns with
the level dim leading through ``xarray_api``'s fused pipelines, the surface
solve and the storm proxies with the default device, every variable equal
to the tensor-level path's, with the call's time split into lowering,
copies, compute and lifting (phase 10); and the same Dataset streamed in
chunks of 65,536 columns, with its rate and peak memory (phase 11).  Then
the modules around them: a 2-way mesh on the one card (the same device
twice) with an uneven batch through ``parallel.sharded_map``, ``mesh=`` on
the Dataset call whole and streamed, and ``global_stats`` through a
one-process NCCL group (phase 12); a slim deployment artifact with the
kernel library inside, served by ``python -m xarray_parcel_tpu_torch.deploy
serve`` in a fresh process that finds neither the library, nor ``nvcc`` on
its ``PATH``, nor a table cache, then loaded here and called on device
tensors and on host arrays (streamed in chunks), and ``xarray_api.serve``
on the Dataset (phase 13); and the C++ ingest against its numpy form with
both times, and ``utils.columns_per_second`` against phase 5's rate (phase
14).  Last, the JAX package's acceptance tiers through both kernels (phase
15): every tier grid in float64 at the tiers' sizes equal to the plain
twins on the CPU and to the card's modular path, with its launch counts,
and held to the serial oracle (``tests/serial_oracle.py``) under the tiers'
tolerances and filters; the sweep's adversarial classes in float32 at full
width within the float32 budget, with their rate and kernel times.  Each
phase prints one line; the last two lines are the kernel record and the
result line.

Exits non-zero, with no result line, when there is no CUDA device or when
any check fails.  Imports nothing of JAX.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import xarray_parcel_tpu_torch as xt
from parcelbench.harness import card
from xarray_parcel_tpu_torch import (_build, adiabat, deploy, fused, native,
                                     parallel, parcels, thermo, utils)
from xarray_parcel_tpu_torch import diagnostics as diag
from xarray_parcel_tpu_torch import xarray_api as xapi
from xarray_parcel_tpu_torch.lcl import lcl

MAIN_COLUMNS = 786_432          # the pipeline batch of the TPU-era bench
LEVELS = 90
CHECK_COLUMNS = 4096            # subsample held against the CPU plain path
HARD_COLUMNS = 2055             # x4 parcel variants: 8,220 columns
TAIL_COLUMNS = 4099             # hard columns of the tail check
EDGE_LEVELS = (33, 137)         # other widths, around the lanes' wrap
EDGE_COLUMNS = 1031             # x4 parcel variants for the solve
MIX_COLUMNS = 4103              # hard rows of the mixed-layer check
MU_COLUMNS = 4111               # hard rows of the most-unstable check
# The most-unstable check's widths: one level up to the longest model
# levels, the device cells' 13, 35 and 90, and EDGE_LEVELS.
MU_LEVELS = (1, 2, 13, 33, 35, 90, 137)
kWarp = 32                      # lanes of a warp, each striding over levels
GRID = (768, 1024)              # the Dataset's horizontal grid: MAIN_COLUMNS
SMALL_GRID = (64, 128)          # the mixed-dims Dataset (1-D pressure)
STREAM_COLUMNS = 65_536         # chunk of the streamed Dataset call
# K, moist_lapse's table modes against the integrator: the bilinear index,
# and the nearest cell, which snaps the parcel to the 0.02 K x 0.5 hPa grid
# (an error that grows along the adiabat).
TABLE_ATOL = {'bilinear': 0.05, 'nearest': 0.15}
# The solve's options: each alone and all four together.
SOLVE_OPTIONS = [dict(), dict(virtual_temperature_correction=False),
                 dict(lcl_interp='linear'), dict(pos_cape_neg_cin=False),
                 dict(post_zero_cin=True),
                 dict(virtual_temperature_correction=False,
                      lcl_interp='linear', pos_cape_neg_cin=False,
                      post_zero_cin=True)]
GOLDEN = dict(cape=230.20, cin=-58.07, tol=0.5)
# The pre-pass kernel against its twin, as shares of each output's scale.
PREPASS_TOL = {torch.float32: 1e-5, torch.float64: 1e-11}
# The device cells' neighbours: (cell's deployment, columns, levels,
# pressure the broadcast of one row).
NEIGHBOR_SHAPES = (('era5_pl35', 1_038_240, 35, True),
                   ('aus400_ml90', 786_432, 90, False),
                   ('gencast_ens50_pl13', 5_191_200, 13, True))
F64_ATOL = 1e-6
# float32 budget (docs/performance.md): relative to each output's scale.
F32_P95, F32_MAX, F32_NAN_FLIPS = 1e-4, 5e-4, 0.01


def log(msg):
    print(msg, flush=True)


def synthetic_columns(batch, L=LEVELS, seed=0):
    """Plausible NaN-free soundings (p, t, td), float32 -- the TPU-era
    bench's generator."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1008.0, 120.0, L, dtype=np.float64)
    t = 302.0 - 75.0 * (1.0 - (p / 1008.0) ** 0.28)
    t = np.broadcast_to(t, (batch, L)) + rng.normal(0.0, 1.5, (batch, L))
    td = t - np.abs(rng.normal(6.0, 4.0, (batch, L))) - 0.5
    p = np.broadcast_to(p, (batch, L))
    return p.astype(np.float32), t.astype(np.float32), td.astype(np.float32)


def synthetic(batch, L=LEVELS, seed=0):
    """The pipeline's input dict, made as the TPU-era bench made it."""
    p, t, td = synthetic_columns(batch, L=L, seed=seed)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    rng = np.random.default_rng(seed + 1)
    return {
        'pressure': p, 'temperature': t,
        'specific_humidity': q.astype(np.float32),
        'height_asl': h.astype(np.float32),
        'surface_wind_u': rng.normal(3, 2, (batch,)).astype(np.float32),
        'surface_wind_v': rng.normal(0, 2, (batch,)).astype(np.float32),
        'wind_u': rng.normal(8, 5, (batch, L)).astype(np.float32),
        'wind_v': rng.normal(2, 5, (batch, L)).astype(np.float32),
        'wind_height_above_surface': (h - h[..., :1]).astype(np.float32),
    }, td


def _sounding(p, rng):
    """Environment t and td (float64) for pressures ``p``, as
    :func:`hard_columns` makes them."""
    t = 302.0 - 76.0 * (1.0 - (p / 1010.0) ** 0.3) + rng.normal(0, 2, p.shape)
    td = (t - np.abs(rng.normal(2.0, 2.0, p.shape)) - 0.2
          - 15.0 * (1.0 - p / 1010.0) ** 2)
    return t, td


def hard_columns(n, L=LEVELS, seed=7):
    """Convective soundings (float64) with the cases the kernel must get
    right: poisoned temperature columns, a NaN surface dewpoint, NaN
    pressure padding at the top, an interior NaN level, duplicate levels
    (at the surface and aloft), parcels too hot for the adiabat family and
    all-NaN columns."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1010.0, 150.0, L) + rng.normal(0, 0.4, (n, L))
    p = -np.sort(-p, axis=-1)
    t, td = _sounding(p, rng)
    k = n // 20
    r = rng.permutation(n)
    t[r[:k]] = np.nan
    td[r[k:2 * k], 0] = np.nan
    p[r[2 * k:3 * k], -10:] = np.nan
    t[r[3 * k:4 * k], L // 2] = np.nan
    p[r[4 * k:5 * k], L // 4 + 1] = p[r[4 * k:5 * k], L // 4]
    p[r[5 * k:6 * k], 1] = p[r[5 * k:6 * k], 0]
    t[r[6 * k:7 * k], 0] += 45.0
    p[r[7 * k:7 * k + 3]] = np.nan
    return p, t, td


def tail_columns(n, L=LEVELS, seed=11):
    """Soundings (float64 p, t, td, h) with the cases the diagnostics-tail
    kernel must get right: levels exactly at 850, 700 and 500 hPa and
    duplicated there, columns topping out below 500 hPa, T exactly
    273.15 K at a level, no 0 C crossing, inversions with several
    crossings, NaN heights, NaN levels (interior, top padding and a
    leading prefix), a NaN temperature at an anchor, columns stored top
    down (the lowest crossing is then the last one found) and all-NaN
    columns."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1010.0, 150.0, L) + rng.normal(0, 0.4, (n, L))
    p = -np.sort(-p, axis=-1)
    t = 300.0 - 80.0 * (1.0 - (p / 1010.0) ** 0.3) + rng.normal(0, 1, (n, L))
    td = t - np.abs(rng.normal(3.0, 2.0, (n, L))) - 0.1
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19) + rng.normal(0, 5, (n, L))
    groups = np.array_split(rng.permutation(n), 14)
    for target, g, dup in ((850.0, groups[0], False), (700.0, groups[1], False),
                           (500.0, groups[2], False), (850.0, groups[3], True),
                           (500.0, groups[4], True)):
        j = np.abs(p[g] - target).argmin(-1)
        p[g, j] = target
        if dup:                            # the level above duplicates it
            p[g, np.minimum(j + 1, L - 1)] = target
    g = groups[5]                          # tops out below 500 hPa
    p[g] = np.linspace(1010.0, 560.0, L)
    g = groups[6]                          # T exactly 0 C at a level
    j = np.abs(t[g] - 273.15).argmin(-1)
    t[g, j] = 273.15
    g = groups[7]                          # no 0 C crossing
    t[g[: len(g) // 2]] += 120.0
    t[g[len(g) // 2:]] -= 90.0
    g = groups[8]                          # inversions: several crossings
    wave = np.array([2.0, -1.5, 1.0, -2.0, 0.5, -1.0])[:L - L // 3]
    j = slice(L // 3, L // 3 + len(wave))
    t[g, j] = 273.15 + wave
    td[g, j] = t[g, j] - 0.3
    g = groups[9]                          # NaN heights and NaN levels
    h[g, rng.integers(0, L, len(g))] = np.nan
    p[g, rng.integers(0, L, len(g))] = np.nan
    g = groups[10]                         # NaN top padding, leading prefix
    p[g, -8:] = np.nan
    p[g, :3] = np.nan
    g = groups[11]                         # NaN temperature at an anchor
    j = np.abs(p[g] - 850.0).argmin(-1)
    p[g, j] = 850.0
    t[g, j] = np.nan
    g = groups[12]                         # stored top down
    p[g], t[g], td[g], h[g] = (x[g, ::-1] for x in (p, t, td, h))
    g = groups[13][:3]                     # all-NaN columns
    p[g] = t[g] = td[g] = h[g] = np.nan
    return p, t, td, h


def lane_edges(L):
    """The level indices where a warp's lanes wrap (31/32, 63/64) that a
    column of L levels has."""
    return [e for e in (kWarp - 1, kWarp, 2 * kWarp - 1, 2 * kWarp) if e < L]


def lane_edge_columns(n, L=LEVELS, seed=19):
    """:func:`hard_columns` plus columns whose hard cases straddle the lanes
    31/32 and 63/64 of a warp that strides over the levels: the LCL slot
    at an edge (the surface parcel's LCL between levels e-1 and e),
    duplicated levels across it, NaN gaps (pressure, temperature or
    dewpoint) beside it, and a pressure pair repeated out of order
    (P1 P2 P1 P2 P1 with equal temperatures), whose equal gaps give exactly
    tied LFC and EL candidates in different lanes.  Float64 (p, t, td)."""
    rng = np.random.default_rng(seed)
    p, t, td = hard_columns(n, L=L, seed=seed)
    edges = lane_edges(L)
    if not edges:
        return p, t, td
    groups = np.array_split(rng.permutation(n), 8)
    # The LCL slot at an edge: fresh columns with e levels at or below it.
    g = groups[0]
    p[g] = np.linspace(1010.0, 150.0, L) + rng.normal(0, 0.4, (len(g), L))
    p[g] = -np.sort(-p[g], axis=-1)
    t[g], td[g] = _sounding(p[g], rng)
    td[g, 0] = t[g, 0] - rng.uniform(3.0, 12.0, len(g))
    lcl_p = lcl(*(torch.as_tensor(x[g, 0]) for x in (p, t, td)))[
        'lcl_pressure'].numpy()
    for k, c in enumerate(g):
        e = edges[k % len(edges)]
        p0 = p[c, 0]
        p[c, :e] = np.linspace(p0, lcl_p[k] + 0.05, e)
        p[c, e:] = np.linspace(lcl_p[k] - 0.05, 150.0, L - e)
        t0, td0 = t[c, 0], td[c, 0]
        t[c], td[c] = _sounding(p[c], rng)
        t[c, 0], td[c, 0] = t0, td0
    for k, c in enumerate(groups[1]):     # duplicated level across an edge
        e = edges[k % len(edges)]
        p[c, e] = p[c, e - 1]
    for k, c in enumerate(groups[2]):     # NaN gaps beside an edge
        e = edges[k % len(edges)]
        (p, t, td)[k % 3][c, e - (k // 3) % 2] = np.nan
    for k, c in enumerate(groups[3]):     # P1 P2 P1 P2 P1 across an edge
        e = edges[k % len(edges)]
        lo = max(e - 2, 1)
        if lo + 5 > L:
            continue
        pair = p[c, lo:lo + 2].copy()
        temps = (t[c, lo] + 8.0, t[c, lo + 1] - 8.0)
        for r in range(5):
            p[c, lo + r] = pair[r % 2]
            t[c, lo + r] = temps[r % 2]
            td[c, lo + r] = temps[r % 2] - 1.0
    return p, t, td


def lane_edge_args(n, tables, L=LEVELS, seed=19):
    """The solve's packed arguments (:func:`kernel_args`) for
    :func:`lane_edge_columns` of the tables' dtype and device, with, in a
    few columns each, the first valid level k0 at L-1 and L-2 (the rest a
    NaN prefix) and a NaN LCL pressure (every slot then the LCL's)."""
    dtype, dev = tables.coeffs.dtype, tables.coeffs.device
    cols = [torch.as_tensor(x, dtype=dtype, device=dev)
            for x in lane_edge_columns(n, L=L, seed=seed)]
    p, t, td, row, scalars, k0 = kernel_args(*cols, tables)
    p, scalars, k0 = p.clone(), scalars.clone(), k0.clone()
    for c, k in ((0, L - 1), (1, L - 2), (2, L - 1)):
        p[c, :k] = torch.nan
        k0[c] = k
    scalars[3:6, 0] = torch.nan
    return p, t, td, row, scalars, k0


def lane_edge_tail_columns(n, L=LEVELS, seed=23):
    """:func:`tail_columns` plus columns whose hard cases straddle the lanes
    31/32 and 63/64: a level exactly at 850, 700 or 500 hPa at an edge,
    duplicated across it; the 0 C crossing of T (and of the wet bulb) in
    the gap across it, with a second, higher crossing so that the lowest
    one must be found by value; NaN pressures and heights beside it; an
    anchor level repeated 32 levels apart, so that one lane holds both.
    Float64 (p, t, td, h)."""
    rng = np.random.default_rng(seed)
    p, t, td, h = tail_columns(n, L=L, seed=seed)
    edges = lane_edges(L)
    if not edges:
        return p, t, td, h
    groups = np.array_split(rng.permutation(n), 4)
    if L > kWarp:                         # an anchor level twice, 32
        for k, c in enumerate(groups[3]):  # levels apart: one lane holds both
            j = k % (L - kWarp)
            p[c, [j, j + kWarp]] = (850.0, 700.0, 500.0)[k % 3]
    for k, c in enumerate(groups[0]):     # an anchor level at an edge
        e = edges[k % len(edges)]
        target = (850.0, 700.0, 500.0)[k % 3]
        p[c, :e] = np.linspace(1010.0, target + 5.0, e)
        p[c, e:] = np.linspace(target, 150.0, L - e)
        if k % 2:
            p[c, e - 1] = target          # duplicated across the edge
    for k, c in enumerate(groups[1]):     # 0 C crossing across an edge
        e = edges[k % len(edges)]
        t[c] = 273.15 + 0.7 * (e - 0.5 - np.arange(L))
        td[c] = t[c] - 0.5
        hi = min(e + 3 + k % 5, L - 1)
        t[c, hi:] += 10.0                 # a second crossing above
    for k, c in enumerate(groups[2]):     # NaN beside an edge
        e = edges[k % len(edges)]
        (p, h)[k % 2][c, e - (k // 2) % 2] = np.nan
    return p, t, td, h


# --- The JAX package's acceptance-tier inputs, with numpy only ----------------
# Copies of the generators of tests/test_integration_serial.py (make_grid),
# tests/test_pipeline_fuzz.py (the sweep's five classes, winds included),
# tests/test_multicross_fuzz.py (zigzag soundings and the selection of both
# sets), tests/test_nan_fuzz.py and tests/test_pathological.py, for the
# card's machine, which has no JAX.  tests/test_torch_tier_inputs.py holds
# each equal to the JAX test module's own; phase 15 runs them through the
# kernels, and the tier files tests/test_torch_*.py through the port on the
# CPU, with the comparisons below.

SWEEP_CASES = ('dup_pressure', 'interior_nan', 'near_envelope',
               'deep_depression', 'combined')
SWEEP_N, SWEEP_L = 12, 48
MULTICROSS_L = 44
PATHOLOGICAL_L = 40
SWEEP_PROBES = (('mu', 'mu'), ('m100', 'mixed_100'), ('m50', 'mixed_50'))


def serial_oracle():
    """The repo's serial per-column oracle, ``tests/serial_oracle.py``
    (numpy and scipy only)."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests')
    if folder not in sys.path:
        sys.path.insert(0, folder)
    import serial_oracle
    return serial_oracle


def make_grid(ny=8, nx=8, L=48, seed=7):
    """Convectively active (ny, nx, L) float64 soundings (p, t, td): moist
    near the surface, drying aloft."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1012.0, 150.0, L)
    p = np.broadcast_to(p, (ny, nx, L)) + rng.normal(0, 0.5, (ny, nx, L))
    p = -np.sort(-p, axis=-1)
    t = 303.0 - 78.0 * (1.0 - (p / 1012.0) ** 0.31) + rng.normal(
        0, 2.0, (ny, nx, L))
    depression = (np.abs(rng.normal(1.5, 1.5, (ny, nx, L))) + 0.2 +
                  18.0 * (1.0 - p / 1012.0) ** 2)
    td = t - depression
    return p, t, td


def sweep_mutate(case, p, t, td, rng):
    """One adversarial class of the pipeline sweep, in place on (B, L)
    columns: duplicated levels, interior NaN runs, near-saturated or
    deep-depression launches, or all three on one grid."""
    L = p.shape[-1]
    if case == 'dup_pressure':
        for j in range(p.shape[0]):
            for k in rng.choice(np.arange(4, L - 6), rng.integers(1, 4),
                                replace=False):
                p[j, k + 1] = p[j, k]
        p[:] = -np.sort(-p, axis=-1)
    elif case == 'interior_nan':
        # Mostly high in the column (above the typical EL); a couple of
        # low runs.
        for j in range(p.shape[0]):
            if j % 3 == 2:
                continue
            k = int(rng.integers(5, 12) if j in (1, 4)
                    else rng.integers(34, L - 8))
            w = int(rng.integers(2, 5))
            p[j, k:k + w] = t[j, k:k + w] = td[j, k:k + w] = np.nan
    elif case == 'near_envelope':
        depr = rng.uniform(0.01, 0.5, p.shape[0])
        td[:, 0] = t[:, 0] - depr
        td[:, 1] = np.minimum(td[:, 1], td[:, 0])
    elif case == 'deep_depression':
        depr = rng.uniform(9.0, 15.0, p.shape[0])
        td[:, 0] = t[:, 0] - depr
        td[:, 1:6] = np.minimum(td[:, 1:6], (td[:, 0] - 1.0)[:, None])
    elif case == 'combined':
        for j in range(p.shape[0]):
            if j % 3 == 0:
                k = int(rng.integers(4, L - 6))
                p[j, k + 1] = p[j, k]
            elif j % 3 == 1:
                k = int(rng.integers(34, L - 8))
                w = int(rng.integers(2, 5))
                p[j, k:k + w] = t[j, k:k + w] = td[j, k:k + w] = np.nan
            else:
                td[j, 0] = t[j, 0] - float(rng.uniform(9.0, 15.0))
                td[j, 1:6] = np.minimum(td[j, 1:6], td[j, 0] - 1.0)
        for j in range(0, p.shape[0], 3):
            p[j] = -np.sort(-p[j])
    else:
        raise ValueError(f'unknown sweep class {case!r}')
    return p, t, td


def sweep_columns(case, n=SWEEP_N, L=SWEEP_L, seed=None):
    """The pipeline sweep's inputs for one class, as its fixture makes
    them: float64 (B, L) p, t and surface-route dewpoint td0, heights h and
    the winds.  ``seed`` defaults to the sweep's (400 + the class's
    index)."""
    if seed is None:
        seed = 400 + SWEEP_CASES.index(case)
    rng = np.random.default_rng(seed)
    p, t, td0 = (v[0].copy() for v in make_grid(ny=1, nx=n, L=L, seed=seed))
    p, t, td0 = sweep_mutate(case, p, t, td0, rng)
    h = 44330.0 * (1.0 - (np.where(np.isnan(p), 500.0, p)
                          / 1013.25) ** 0.19)
    h = np.where(np.isnan(p), np.nan, h)
    winds = {
        'surface_wind_u': rng.normal(3, 2, (n,)),
        'surface_wind_v': rng.normal(0, 2, (n,)),
        'wind_u': rng.normal(8, 5, (n, L)),
        'wind_v': rng.normal(2, 5, (n, L)),
        'wind_height_above_surface': np.broadcast_to(
            np.linspace(0.0, 16000.0, L), (n, L)).copy(),
    }
    return p, t, td0, h, winds


def sweep_inputs(p, t, td0, h, winds, dtype=torch.float64, device='cpu'):
    """The pipeline's input dict of tensors for :func:`sweep_columns`, and
    the dewpoint the pipeline derives from its specific humidity (numpy),
    which the oracle is fed so that both sides lift identical parcels."""
    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    pp, tt = put(p), put(t)
    q = thermo.specific_humidity_from_dewpoint(pp, put(td0))
    td = thermo.dewpoint_from_specific_humidity(pp, tt, q)
    dat = {'pressure': pp, 'temperature': tt, 'specific_humidity': q,
           'height_asl': put(h), **{k: put(v) for k, v in winds.items()}}
    return dat, td.cpu().numpy().astype(np.float64)


def sweep_vector(dat, **kw):
    """``conv_properties(dat, ignore_nans=True, **kw)`` with the probes the
    sweep's filters read: each variant's LFC and EL (``_mu_lfc``, ...) and
    the most-unstable launch pressure, as numpy arrays."""
    out = dict(xt.conv_properties(dat, ignore_nans=True, **kw))
    p, t = dat['pressure'], dat['temperature']
    dew = thermo.dewpoint_from_specific_humidity(p, t,
                                                 dat['specific_humidity'])
    _, mu_prof, mu_parcel = parcels.most_unstable_cape_cin(p, t, dew,
                                                           depth=250.0, **kw)
    _, m100, _ = parcels.mixed_layer_cape_cin(p, t, dew, depth=100.0, **kw)
    _, m50, _ = parcels.mixed_layer_cape_cin(p, t, dew, depth=50.0, **kw)
    for name, prof in (('mu', mu_prof), ('m100', m100), ('m50', m50)):
        out[f'_{name}_lfc'] = prof['lfc_pressure']
        out[f'_{name}_el'] = prof['el_pressure']
    out['_mu_parcel_pressure'] = mu_parcel['pressure']
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def sweep_serial(p, t, td, h, winds):
    """The serial oracle's answers for the sweep's variables, per column of
    the dropna'd column (the oracle's semantics)."""
    oracle = serial_oracle()
    n = p.shape[0]
    keys = [f'{v}_{x}' for v, _ in SWEEP_PROBES
            for x in ('cape', 'cin', 'lfc', 'el', 'li', 'dci')]
    keys += ['mu_parcel_pressure', 'lapse', 't500', 'flh', 'mlh',
             'shear_u', 'shear_v', 'shear_magnitude']
    ser = {k: np.full((n,), np.nan) for k in keys}
    for j in range(n):
        keep = ~np.isnan(p[j])
        pc, tc, tdc, hc = p[j][keep], t[j][keep], td[j][keep], h[j][keep]
        mu = oracle.most_unstable_cape_cin_column(pc, tc, tdc, depth=250.0)
        m100 = oracle.mixed_layer_cape_cin_column(pc, tc, tdc, depth=100.0)
        m50 = oracle.mixed_layer_cape_cin_column(pc, tc, tdc, depth=50.0)
        ser['mu_parcel_pressure'][j] = mu['parcel_pressure']
        for name, res in (('mu', mu), ('m100', m100), ('m50', m50)):
            li = oracle.lifted_index_column(res)
            for x in ('cape', 'cin', 'lfc', 'el'):
                ser[f'{name}_{x}'][j] = res[x]
            ser[f'{name}_li'][j] = li
            ser[f'{name}_dci'][j] = oracle.dci_column(pc, tc, tdc, li)
        ser['lapse'][j] = oracle.lapse_rate_column(pc, tc, hc)
        ser['t500'][j] = oracle.isobar_temperature_column(pc, tc)
        ser['flh'][j] = oracle.freezing_level_height_column(tc, hc)
        ser['mlh'][j] = oracle.melting_level_height_fast_column(tc, tdc, hc)
        sh = oracle.wind_shear_column(
            winds['surface_wind_u'][j], winds['surface_wind_v'][j],
            winds['wind_u'][j], winds['wind_v'][j],
            winds['wind_height_above_surface'][j])
        for k in ('shear_u', 'shear_v', 'shear_magnitude'):
            ser[k][j] = sh[k]
    return ser


def sweep_records(p):
    """Per-column records for the comparability filters: ``nan_pmax``, the
    pressure of the valid level just below a NaN run (0 without NaN
    levels), and ``dup_p``, each column's duplicated pressures."""
    n = p.shape[0]
    nan_pmax = np.zeros(n)
    for j in range(n):
        bad = np.isnan(p[j])
        if bad.any():
            below = np.flatnonzero(bad).min() - 1
            nan_pmax[j] = p[j][below] if below >= 0 else np.inf
    dup_p = [p[j][np.flatnonzero(np.diff(p[j]) == 0)] for j in range(n)]
    return nan_pmax, dup_p


def same_branch(a, b, tol=1.0):
    """Both NaN, or both finite and within ``tol``."""
    both_nan = np.isnan(a) & np.isnan(b)
    both_fin = ~np.isnan(a) & ~np.isnan(b)
    return both_nan | (both_fin & (np.abs(np.where(both_fin, a - b, 0.0))
                                   < tol))


def sweep_comparable(name, p, vec, ser, nan_pmax, dup_p):
    """The sweep's columns where variant ``name`` ('mu', 'm100', 'm50') is
    comparable with the oracle: the same parcel (most unstable), the same
    LFC and EL branch, no NaN run inside the integration windows (the port
    skips areas across a NaN gap, as the reference does, where the dropna
    oracle bridges it), and neither the LFC, the EL nor the launch level on
    a duplicated level (the knife edges of ROADMAP section C)."""
    n = p.shape[0]
    if name == 'mu':
        same = np.abs(vec['_mu_parcel_pressure'] -
                      ser['mu_parcel_pressure']) < 1e-6
    else:
        same = np.ones((n,), bool)
    same = (same & same_branch(vec[f'_{name}_lfc'], ser[f'{name}_lfc'])
            & same_branch(vec[f'_{name}_el'], ser[f'{name}_el']))
    el_eff = np.where(np.isnan(ser[f'{name}_el']),
                      np.array([np.nanmin(col) for col in p]),
                      ser[f'{name}_el'])
    same &= (nan_pmax == 0) | (nan_pmax < el_eff)
    for j in range(n):
        if len(dup_p[j]) and same[j]:
            launch = (ser['mu_parcel_pressure'][j] if name == 'mu'
                      else p[j][~np.isnan(p[j])][0])
            edges = [ser[f'{name}_lfc'][j], ser[f'{name}_el'][j], launch]
            if any(np.nanmin(np.abs(dup_p[j] - e)) < 1e-6
                   for e in edges if np.isfinite(e)):
                same[j] = False
    return same


def check_sweep_variant(what, name, vec, ser, same, tables=False):
    """Hold variant ``name``'s CAPE, CIN, LI and DCI to the oracle on the
    comparable columns ``same``: identical NaN patterns, and the sweep's
    tolerances (1e-4 J/kg, 1e-5 K) for the exact-ODE backend.  With
    ``tables`` (the spectral tables the fused solve reads) the values held
    are the table tier's (``test_integration_serial``): CAPE within 1 J/kg,
    or 1% above 100 J/kg."""
    v = dict(SWEEP_PROBES)[name]
    for var, key, tol in ((f'{v}_cape', f'{name}_cape', 1e-4),
                          (f'{v}_cin', f'{name}_cin', 1e-4),
                          (f'{v}_lifted_index', f'{name}_li', 1e-5),
                          (f'{v}_dci', f'{name}_dci', 1e-5)):
        a, b = vec[var][same], ser[key][same]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f'{what}: {var} NaN pattern')
        both = ~np.isnan(a)
        if not both.any():
            raise AssertionError(f'{what}: {var} all-NaN on comparable '
                                 f'columns')
        d = np.abs(a[both] - b[both])
        if tables:
            if not var.endswith('cape'):
                continue
            rel = d / np.maximum(np.abs(b[both]), 100.0)
            d, tol = np.minimum(d, rel * 100.0), 1.0
        if not d.max() < tol:
            raise AssertionError(f'{what}: {var} max diff {d.max():.3e}')


def check_sweep_scalars(what, vec, ser, nan_pmax):
    """The sweep's scalar diagnostics against the oracle: NaN patterns on
    NaN-free columns, values where both sides are finite (the
    level-interpolating ones on NaN-free columns only: a bridged NaN gap
    can hand the oracle another isotherm crossing), within 1e-6 (shear
    1e-8), on at least a quarter of the columns."""
    no_nan = nan_pmax == 0
    for var, key, tol in (('lapse_rate_700_500', 'lapse', 1e-6),
                          ('temp_500', 't500', 1e-6),
                          ('freezing_level', 'flh', 1e-6),
                          ('melting_level', 'mlh', 1e-6),
                          ('shear_u', 'shear_u', 1e-8),
                          ('shear_v', 'shear_v', 1e-8),
                          ('shear_magnitude', 'shear_magnitude', 1e-8)):
        a, b = vec[var], ser[key]
        if not np.array_equal(np.isnan(a[no_nan]), np.isnan(b[no_nan])):
            raise AssertionError(f'{what}: {var} NaN pattern')
        both = ~np.isnan(a) & ~np.isnan(b)
        if not var.startswith('shear'):
            both = both & no_nan
        if not both.mean() > 0.25:
            raise AssertionError(f'{what}: {var} barely comparable')
        d = np.abs(a[both] - b[both])
        if not d.max() < tol:
            raise AssertionError(f'{what}: {var} max diff {d.max():.3e}')


def zigzag_column(rng, depression=(1.0, 6.0), L=MULTICROSS_L):
    """One sounding whose environment oscillates around the parcel's own
    track (the oracle's physics), with ``depression`` bounding the surface
    dewpoint depression: (p, t_env, td_env, t0, td0)."""
    oracle = serial_oracle()
    p = np.linspace(1009.0, 190.0, L) + rng.normal(0, 0.4, L)
    p = -np.sort(-p)
    t0 = 295.0 + rng.uniform(-4.0, 6.0)
    td0 = t0 - rng.uniform(*depression)
    lcl_p, lcl_t = oracle.lcl(p[0], t0, td0)
    track = np.where(p >= lcl_p, oracle.dry_lapse(p, t0, p[0]),
                     oracle.moist_lapse(p, lcl_t, lcl_p))
    n_waves = rng.integers(2, 5)
    phase = rng.uniform(0, 2 * np.pi)
    amp = rng.uniform(1.2, 3.0)
    x = np.linspace(0, n_waves * np.pi, L)
    t_env = track + amp * np.sin(x + phase) + rng.normal(0, 0.08, L)
    td_env = t_env - (np.abs(rng.normal(2.0, 1.5, L)) + 0.3)
    return p, t_env, td_env, t0, td0


def _crossings(res):
    """(pressure, direction) of every crossing of the oracle's spliced
    real-temperature tracks."""
    pp, d = res['pp'], res['parcel_t'] - res['env_t']
    lx = np.log(pp)
    out = []
    for i in range(len(pp) - 1):
        if np.sign(d[i]) != np.sign(d[i + 1]):
            cx = (d[i + 1] * lx[i] - d[i] * lx[i + 1]) / (d[i + 1] - d[i])
            out.append((float(np.exp(cx)), 1 if d[i + 1] > 0 else -1))
    return out


def crossing_stats(res):
    """(#increasing, #decreasing, least gap between two crossings)."""
    xs = _crossings(res)
    inc = sum(1 for _, s in xs if s > 0)
    gap = (np.min(np.diff(np.sort([x for x, _ in xs]))) if len(xs) > 1
           else np.inf)
    return inc, len(xs) - inc, float(gap)


def increasing_crossings(res):
    """Pressures of all increasing crossings (before the above-LCL
    exclusion)."""
    return [x for x, s in _crossings(res) if s > 0]


@functools.lru_cache(maxsize=None)
def multicross_set(kind):
    """The multicross fuzz's columns and their oracle answers
    (``cape_cin_column`` without the virtual-temperature correction):
    'base', 24 zigzag columns with >= 2 increasing and decreasing crossings
    >= 8 hPa apart; 'deep', 8 high-LCL columns where the oracle's LFC is
    not the bottom-most increasing crossing (the exclusion and LCL
    substitution rules decided it)."""
    oracle = serial_oracle()
    deep = kind == 'deep'
    rng = np.random.default_rng(20260821 if deep else 20260820)
    want, tries = (8, 300) if deep else (24, 400)
    cols, serial = [], []
    attempts = 0
    while len(cols) < want and attempts < tries:
        attempts += 1
        p, t, td, t0, td0 = zigzag_column(
            rng, **(dict(depression=(9.0, 15.0)) if deep else {}))
        res = oracle.cape_cin_column(p, t, td, p[0], t0, td0,
                                     virtual_temperature_correction=False)
        inc, dec, gap = crossing_stats(res)
        if inc < 2 or gap < 8.0 or (dec < 2 and not deep):
            continue
        if deep:
            inc_x = increasing_crossings(res)
            if not (np.isnan(res['lfc'])
                    or abs(res['lfc'] - max(inc_x)) > 1.0):
                continue
        cols.append((p, t, td, t0, td0))
        serial.append(res)
    if len(cols) != want:
        raise AssertionError(f'multicross {kind}: only {len(cols)} columns '
                             f'in {attempts}')
    return cols, serial


def stack_columns(cols):
    """(p, t, td, t0, td0) arrays of a multicross set's columns."""
    return tuple(np.stack([c[i] for c in cols]) for i in range(3)) + tuple(
        np.array([c[i] for c in cols]) for i in (3, 4))


def check_multicross(what, serial, cape, cin, lfc, el, keep=None):
    """The multicross tier's comparison: per column, LFC and EL NaN with
    the oracle's or within 1 hPa, CAPE and CIN within 1.5 J/kg.
    ``keep``: the columns compared (default all)."""
    for i, s in enumerate(serial):
        if keep is not None and not keep[i]:
            continue
        for name, v, sv in (('lfc', lfc[i], s['lfc']), ('el', el[i], s['el'])):
            if np.isnan(sv):
                if not np.isnan(v):
                    raise AssertionError(f'{what} col {i} {name}: {v} vs '
                                         f'serial NaN')
            elif not abs(v - sv) < 1.0:
                raise AssertionError(f'{what} col {i} {name}: {v} vs {sv}')
        for name, v, sv in (('cape', cape[i], s['cape']),
                            ('cin', cin[i], s['cin'])):
            if not abs(v - sv) < 1.5:
                raise AssertionError(f'{what} col {i} {name}: {v} vs {sv}')


def nan_fuzz_grid(seed, B=64, L=32):
    """The NaN fuzz's float64 (B, L) p, t, td: top padding, interior NaN
    temperatures and dewpoints, all-NaN columns and a NaN surface
    temperature, by column modulo 6."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1008.0, 200.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.3, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 301.0 - 72.0 * (1.0 - (p / 1008.0) ** 0.3) + rng.normal(
        0, 2, (B, L))
    td = t - np.abs(rng.normal(4, 4, (B, L))) - 0.2
    for i in range(B):
        mode = i % 6
        if mode == 1:
            n = rng.integers(1, L // 2)
            p[i, L - n:] = t[i, L - n:] = td[i, L - n:] = np.nan
        elif mode == 2:
            t[i, rng.choice(L, rng.integers(1, 5), replace=False)] = np.nan
        elif mode == 3:
            td[i, rng.choice(L, rng.integers(1, 5), replace=False)] = np.nan
        elif mode == 4:
            p[i] = t[i] = td[i] = np.nan
        elif mode == 5:
            t[i, 0] = np.nan
    return p, t, td


def all_nan_grid():
    """The NaN fuzz's all-NaN (8, 16) grid."""
    return np.full((8, 16), np.nan)


def pathological_grid():
    """Nine degenerate but valid float64 columns of 40 levels: saturated
    from the surface, saturated at the surface only, isothermal, a strong
    inversion (no LFC), very cold near the table's edge, four valid levels
    under NaN padding, a superadiabatic surface layer, an 8-level run
    1e-3 hPa apart and a moist tropical column."""
    L = PATHOLOGICAL_L

    def base():
        p = np.linspace(1005.0, 180.0, L)
        t = 300.0 - 70.0 * (1.0 - (p / 1005.0) ** 0.3)
        return p, t, t - 6.0

    cols = []
    p, t, _ = base()
    cols.append((p, t, t.copy()))
    p, t, td = base()
    td = td.copy()
    td[0] = t[0]
    cols.append((p, t, td))
    p, _, _ = base()
    t = np.full(L, 263.0)
    cols.append((p, t, t - 8.0))
    p, _, _ = base()
    t = 250.0 + 40.0 * (1.0 - p / 1005.0)
    cols.append((p, t, t - 10.0))
    p, _, _ = base()
    t = 218.0 - 25.0 * (1.0 - (p / 1005.0) ** 0.3)
    cols.append((p, t, t - 3.0))
    p, t, td = (x.copy() for x in base())
    p[4:] = t[4:] = td[4:] = np.nan
    cols.append((p, t, td))
    p, t, td = base()
    t = t.copy()
    t[0] += 12.0
    cols.append((p, t, td))
    p, t, td = base()
    p = p.copy()
    k = np.argmin(np.abs(p - 700.0))
    p[k:k + 8] = p[k] - 1e-3 * np.arange(8)
    p = -np.sort(-p)
    cols.append((p, t, td))
    p, _, _ = base()
    t = 304.0 * (p / 1005.0) ** 0.19
    cols.append((p, t, t - 1.0))
    return tuple(np.stack([c[i] for c in cols]) for i in range(3))


def pathological_dataset(p, t, td):
    """The pipeline's float64 numpy inputs for :func:`pathological_grid`:
    specific humidity from the dewpoint, heights and seeded winds."""
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (np.where(np.isnan(p), 500.0, p) / 1013.25) ** 0.19)
    B, L = p.shape
    rng = np.random.default_rng(7)
    return {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (B,)),
        'surface_wind_v': rng.normal(0, 2, (B,)),
        'wind_u': rng.normal(8, 5, (B, L)),
        'wind_v': rng.normal(2, 5, (B, L)),
        'wind_height_above_surface': h - h[..., :1],
    }


def exact_misses(what, want, got, rel=1e-10):
    """Hold the outputs ``got`` to ``want`` (dicts of tensors or arrays
    with the same keys, batch first): booleans and NaN patterns identical
    (raises otherwise), and every float output within ``rel`` of its scale,
    max(1, max |want|).  Returns ``{key: (max |diff|, its column)}`` of the
    outputs over ``rel``."""
    def host(x):
        return (x.detach().cpu().numpy() if torch.is_tensor(x)
                else np.asarray(x))
    if set(want) != set(got):
        raise AssertionError(f'{what}: outputs {sorted(got)} vs '
                             f'{sorted(want)}')
    misses = {}
    for k in sorted(want):
        a, b = host(want[k]), host(got[k])
        if a.shape != b.shape:
            raise AssertionError(f'{what}/{k}: shape {b.shape} vs {a.shape}')
        if a.dtype == bool:
            if not np.array_equal(a, b):
                raise AssertionError(f'{what}/{k}: booleans differ in '
                                     f'{int((a != b).sum())} columns')
            continue
        a, b = a.astype(np.float64), b.astype(np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f'{what}/{k}: NaN patterns differ in '
                                 f'{int((np.isnan(a) != np.isnan(b)).sum())} '
                                 f'columns')
        d = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
        scale = max(1.0, float(np.nanmax(np.abs(a)))
                    if np.isfinite(a).any() else 1.0)
        if d.size and d.max() > rel * scale:
            misses[k] = (float(d.max()), int(d.reshape(-1).argmax()))
    return misses


# The tier grids phase 15 and the card tests run through the kernels: the
# sweep's five classes and the pathological grid through both fused
# pipelines; the multicross sets, the NaN fuzz, the all-NaN grid and
# make_grid through the solve.
TIER_GRIDS = tuple(f'sweep/{c}' for c in SWEEP_CASES) + (
    'pathological', 'multicross/base', 'multicross/deep', 'nan_fuzz/0',
    'nan_fuzz/1', 'nan_fuzz/2', 'all_nan', 'make_grid')
SOL_KEYS = ('lfc_pressure', 'lfc_temperature', 'el_pressure',
            'el_temperature')


def tier_inputs(name, device, dtype=torch.float64):
    """The inputs of tier grid ``name`` on ``device``: the pipeline's dict
    for a sweep class and the pathological grid; else ``(p, t, td)``
    (B, L) and, for the multicross sets, the parcel (p0, t0, td0)."""
    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    kind, _, arg = name.partition('/')
    if kind == 'sweep':
        return sweep_inputs(*sweep_columns(arg), dtype=dtype,
                            device=device)[0]
    if kind == 'pathological':
        return {k: put(v) for k, v in
                pathological_dataset(*pathological_grid()).items()}
    if kind == 'multicross':
        p, t, td, t0, td0 = stack_columns(multicross_set(arg)[0])
        return tuple(put(x) for x in (p, t, td, p[:, 0], t0, td0))
    if kind == 'nan_fuzz':
        return tuple(put(x) for x in nan_fuzz_grid(int(arg)))
    if kind == 'all_nan':
        return (put(all_nan_grid()),) * 3
    if kind == 'make_grid':
        return tuple(put(x.reshape(-1, x.shape[-1])) for x in make_grid())
    raise ValueError(f'unknown tier grid {name!r}')


def tier_paths(name):
    """``[(label, kernel path, modular path, (solve, tail) launches)]`` of
    tier grid ``name``: each path ``fn(inputs, tables)`` returns a dict of
    (B,) outputs."""
    kind = name.partition('/')[0]
    if kind in ('sweep', 'pathological'):
        kw = dict(ignore_nans=kind == 'sweep')
        return [('conv_properties_fused',
                 lambda d, tab: xt.conv_properties_fused(d, tables=tab, **kw),
                 lambda d, tab: xt.conv_properties(d, tables=tab, **kw),
                 (3, 1)),
                ('min_conv_properties_fused',
                 lambda d, tab: xt.min_conv_properties_fused(d, tables=tab),
                 lambda d, tab: xt.min_conv_properties(d, tables=tab),
                 (1, 1))]
    if kind == 'multicross':
        opts = dict(virtual_temperature_correction=False)

        def solve(a, tab):
            res, sol = xt.fused_cape_cin(
                *a[:3], parcel_pressure=a[3], parcel_temperature=a[4],
                parcel_dewpoint=a[5], tables=tab, **opts)
            return {**res, **sol}

        def modular(a, tab):
            res, prof = xt.cape_cin(*a[:3], a[4], a[3], a[5], tables=tab,
                                    **opts)
            return {**res, **{k: prof[k] for k in SOL_KEYS}}
        return [('fused_cape_cin', solve, modular, (1, 0))]

    def surface(a, tab):
        res, sol = xt.fused_surface_cape_cin(*a, tables=tab)
        return {**res, **sol}

    def modular(a, tab):
        res, prof = xt.surface_based_cape_cin(*a, tables=tab)
        return {**res, **{k: prof[k] for k in SOL_KEYS}}
    return [('fused_surface_cape_cin', surface, modular, (1, 0))]


def hold_tier(name, tables, device):
    """Run tier grid ``name`` (float64) through the kernel path on
    ``device``, with the launch counts asserted on a card, and hold it to
    the plain twins on the CPU and to the modular path on ``device``:
    identical NaN and boolean patterns, values within 1e-10 of each
    output's scale, or, where only that fails, within ``F64_ATOL``.
    Returns ``(outputs, notes, launches)``: each path's outputs as numpy
    arrays, a line for every output held to ``F64_ATOL`` instead, naming
    the column that shows it, and the (solve, tail) launches of the
    kernel paths."""
    cpu = torch.device('cpu')
    cpu_tables = xt.AdiabatTables(tables.coeffs.to(cpu))
    inputs = tier_inputs(name, device)
    cpu_inputs = ({k: v.to(cpu) for k, v in inputs.items()}
                  if isinstance(inputs, dict)
                  else tuple(x.to(cpu) for x in inputs))
    outs, notes, launches = {}, [], np.zeros(2, int)
    for label, run, modular, counts in tier_paths(name):
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        got = run(inputs, tables)
        seen = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if torch.device(device).type == 'cuda' and seen != counts:
            raise AssertionError(f'{name}/{label}: (solve, tail) launches '
                                 f'{seen}, want {counts}')
        launches += seen
        for ref_name, ref in (('CPU twins', run(cpu_inputs, cpu_tables)),
                              ('modular', modular(inputs, tables))):
            what = f'{name}/{label} vs {ref_name}'
            for k, (d, col) in exact_misses(what, ref, got).items():
                if not d <= F64_ATOL:
                    raise AssertionError(f'{what}/{k}: max |diff| {d:.3g} '
                                         f'(column {col}) over 1e-10 of '
                                         f'scale and {F64_ATOL}')
                notes.append(f'{what}/{k}: |diff| {d:.3g} at column {col}, '
                             f'over 1e-10 of scale, within {F64_ATOL}')
        outs[label] = {k: v.detach().cpu().numpy() for k, v in got.items()}
    return outs, notes, tuple(int(n) for n in launches)


def variant_columns(p, t, td):
    """Four parcel variants of the same columns -- surface, most unstable
    (NaN prefix below the parcel) and mixed 100 / 50 hPa (slot-written
    parcel) -- concatenated on the batch axis, as the main path builds
    them.  Returns (fields, parcel) dicts of pressure, temperature and
    dewpoint."""
    variants = [({'pressure': p, 'temperature': t, 'dewpoint': td},
                 {'pressure': p[:, 0], 'temperature': t[:, 0],
                  'dewpoint': td[:, 0]}),
                parcels.from_most_unstable_parcel(p, t, td, depth=250.0),
                parcels.mix_layer(p, t, td, depth=100.0, grow=False),
                parcels.mix_layer(p, t, td, depth=50.0, grow=False)]
    keys = ('pressure', 'temperature', 'dewpoint')
    return ({k: torch.cat([f[k] for f, _ in variants]).contiguous()
             for k in keys},
            {k: torch.cat([q[k] for _, q in variants]) for k in keys})


def kernel_args(p, t, td, tables):
    """The kernel's packed arguments for :func:`variant_columns`."""
    cols, parcel = variant_columns(p, t, td)
    row, scalars, k0 = fused.prepass(cols['pressure'], parcel['pressure'],
                                     parcel['temperature'],
                                     parcel['dewpoint'], tables)
    return (cols['pressure'], cols['temperature'], cols['dewpoint'], row,
            scalars, k0)


def prepass_args(n, L=LEVELS, seed=5, dtype=torch.float64, device='cpu'):
    """The pre-pass's arguments without the table, (p, p0, t0, td0): the
    four parcel variants of :func:`hard_columns` (NaN parcels, parcels too
    hot for the adiabat family, most-unstable columns led by NaN levels,
    all-NaN columns), with parcels too cold for the family in the first
    five columns and NaN first levels in the next five."""
    p, t, td = (torch.as_tensor(x, dtype=dtype, device=device)
                for x in hard_columns(n, L=L, seed=seed))
    cols, parcel = variant_columns(p, t, td)
    p = cols['pressure'].clone()
    p0, t0, td0 = (parcel[k].clone()
                   for k in ('pressure', 'temperature', 'dewpoint'))
    t0[:5] -= 150.0
    p[5:10, :3] = torch.nan
    return p, p0, t0, td0


def neighbor_columns(n, L, seed=29, dtype=torch.float64, device='cpu'):
    """(pressure, valid), each (n, L), for the neighbours kernel's hard
    cases, by row in turn: all valid; a NaN-led prefix (NaN pressure, not
    valid); an interior invalid run; all invalid; all NaN; a NaN pressure
    under a True valid; tied (repeated) pressures; and unsorted pressures
    with +-inf, scattered invalid levels, a NaN under a True valid and
    ties.  Decreasing pressures elsewhere."""
    rng = np.random.default_rng(seed)
    p = -np.sort(-rng.uniform(5.0, 1050.0, (n, L)), axis=1)
    valid = np.ones((n, L), bool)
    kind = np.arange(n) % 8
    a = rng.integers(0, L, n)
    b = np.minimum(a + rng.integers(1, 6, n), L)
    j = np.arange(L)
    run = (j >= a[:, None]) & (j < b[:, None])
    lead = (kind == 1)[:, None] & (j < a[:, None])
    p[lead] = np.nan
    valid[lead] = False
    valid[(kind == 2)[:, None] & run] = False
    valid[kind == 3] = False
    p[kind == 4] = np.nan
    valid[kind == 4] = False
    nan_at = ((kind == 5) | (kind == 7))[:, None] & (j == a[:, None])
    tie = ((kind == 6) | (kind == 7))[:, None] & run & (j > 0)
    mixed = kind == 7
    p[mixed] = rng.permutation(p[mixed].ravel()).reshape(-1, L)
    p[mixed & (a % 3 == 0), -1] = np.inf
    p[mixed & (a % 3 == 1), 0] = -np.inf
    valid[mixed] = rng.random((int(mixed.sum()), L)) > 0.3
    for k in range(1, L):           # a run of ties: each level its above's
        p[tie[:, k], k] = p[tie[:, k], k - 1]
    p[nan_at] = np.nan
    valid[nan_at] = True
    return (torch.as_tensor(p, dtype=dtype, device=device),
            torch.as_tensor(valid, device=device))


def mix_columns(n, L, seed=37, dtype=torch.float64, device='cpu'):
    """(pressure, temperature, dewpoint), each (n, L), for the mixed-layer
    kernel's hard cases, by row in turn: plain soundings; t and td NaN
    below ground (a NaN-led valid mask under a numeric pressure); a NaN-led
    pressure; an interior invalid run; trailing NaN pressures; all NaN; no
    valid level under a numeric pressure; duplicated levels at the surface
    and around the layer tops; levels exactly on both layer tops (100 and
    50 hPa above the bottom); one valid level in the layers; no valid level
    in them; a column whose bottom lies under 100 hPa (its layer top at or
    under 0 hPa: 95 hPa, and 100 exactly); and unsorted pressures.  Each
    kind that needs more levels than a row has is left plain there."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1010.0, 150.0, L) + rng.normal(0, 0.4, (n, L))
    p = -np.sort(-p, axis=-1)
    t, td = _sounding(p, rng)
    j = np.arange(L)
    for i in range(n):
        kind, a = i % 15, int(rng.integers(1, 4))
        pi, ti, di = p[i], t[i], td[i]
        if kind == 1:
            ti[:a] = di[:a] = np.nan
        elif kind == 2:
            pi[:a] = ti[:a] = di[:a] = np.nan
        elif kind == 3 and L > 2:
            ti[1:1 + a] = np.nan
        elif kind == 4:
            pi[L - a:] = np.nan
        elif kind == 5:
            pi[:] = ti[:] = di[:] = np.nan
        elif kind == 6:
            ti[:] = np.nan
        elif kind == 7 and L > 1:
            pi[1] = pi[0]
            for top in (pi[0] - 100.0, pi[0] - 50.0):
                k = int(np.argmax(pi < top))
                if 0 < k < L - 1:
                    pi[k + 1] = pi[k]
        elif kind == 8:
            for top in (pi[0] - 100.0, pi[0] - 50.0):
                k = int(np.argmax(pi < top)) if (pi < top).any() else 0
                if k > 0:
                    pi[k] = top
        elif kind == 9 and L > 1:
            pi[1:] = np.linspace(pi[0] - 130.0, 150.0, L - 1)
        elif kind == 10:
            ti[pi >= pi[0] - 100.0] = np.nan
        elif kind in (11, 12):
            pi[:] = np.linspace(95.0 if kind == 11 else 100.0, 1.0, L)
        elif kind == 13:
            pi[:] = rng.permutation(pi)
        elif kind == 14:
            pi[:] = pi[::-1]
    p[~np.isfinite(p)] = np.nan
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (p, t, td))


def mix_work(p, t, depths):
    """Bytes the mixed-layer kernel needs: t and td read once, the
    pressure once (one row where every row is that row), and each depth's
    three fields and three parcel values written once."""
    B, L = t.shape
    item = t.element_size()
    rows = 1 if B > 1 and p.stride(0) == 0 else B
    D = len(depths)
    return item * (2 * B * L + rows * L + 3 * D * B * (L + 1)), 0


# chip_smoke.mu_columns' kinds of row, in turn.
MU_KINDS = 16
# The most-unstable prep's depths: the fused pipelines' and the default.
MU_DEPTHS = (250.0, 300.0)


def mu_columns(n, L, seed=41, dtype=torch.float64, device='cpu'):
    """(pressure, temperature, dewpoint), each (n, L), for the
    most-unstable kernel's hard cases, by row in turn (``MU_KINDS``):
    plain soundings; t and td NaN below ground (a NaN-led layer under a
    numeric pressure); a NaN-led pressure; interior NaN pressures; an
    interior NaN temperature; all NaN; no temperature at all (no parcel);
    a tie of ``bound_pressure`` at each of ``MU_DEPTHS`` (two levels
    equally far from the layer's bound, the one below it the most
    unstable, which the larger pressure's win leaves out of the layer); a
    layer of one level (the next level 650 hPa up: shallower than one
    level); a duplicated surface with another temperature; unsorted and
    reversed pressures; a tie of theta-e between the surface and a level
    at its pressure with other t and td (the first level must win: the
    pair is searched on ``device`` with thermo's theta-e, as the twin
    computes it there; a row with no exact tie among the candidates is
    left with the nearest); the surface repeated outright; and levels
    exactly on the layer's bound at each depth.  Each kind that needs
    more levels than a row has is left plain there."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1010.0, 150.0, L) + rng.normal(0, 0.4, (n, L))
    p = -np.sort(-p, axis=-1)
    t, td = _sounding(p, rng)
    ties = []
    for i in range(n):
        kind, a = i % MU_KINDS, int(rng.integers(1, 4))
        pi, ti, di = p[i], t[i], td[i]
        if kind == 1:
            ti[:a] = di[:a] = np.nan
        elif kind == 2:
            pi[:a] = ti[:a] = di[:a] = np.nan
        elif kind == 3 and L > 2:
            pi[1:1 + a] = np.nan
        elif kind == 4 and L > 2:
            ti[1:1 + a] = np.nan
        elif kind == 5:
            pi[:] = ti[:] = di[:] = np.nan
        elif kind == 6:
            ti[:] = np.nan
        elif kind in (7, 8) and L > 3:
            pi[0] = np.round(pi[0])
            bound = pi[0] - MU_DEPTHS[kind - 7]
            k = int(np.argmax(pi < bound)) - 1
            if 0 < k < L - 2:
                pi[k], pi[k + 1] = bound + 2.0, bound - 2.0
                ti[k + 1] = ti[0] + 8.0
                di[k + 1] = ti[k + 1] - 0.5
        elif kind == 9 and L > 1:
            pi[1:] = np.linspace(pi[0] - 650.0, 100.0, L - 1)
        elif kind == 10 and L > 1:
            pi[1] = pi[0]
            ti[1] = ti[0] + 0.7
        elif kind == 11:
            pi[:] = rng.permutation(pi)
        elif kind == 12:
            pi[:] = pi[::-1]
        elif kind == 13 and L > 1:
            pi[1] = pi[0]
            ti[0] += 10.0
            di[0] = ti[0] - 0.5
            ties.append(i)
        elif kind == 14 and L > 1:
            pi[1], ti[1], di[1] = pi[0], ti[0], di[0]
        elif kind == 15 and L > 3:
            pi[0] = np.round(pi[0])
            for depth in MU_DEPTHS:
                k = int(np.argmax(pi < pi[0] - depth))
                if 0 < k < L:
                    pi[k] = pi[0] - depth
    p[~np.isfinite(p)] = np.nan
    p, t, td = (torch.as_tensor(x, dtype=dtype, device=device)
                for x in (p, t, td))
    if ties:
        rows = torch.as_tensor(ties, device=device)
        t[rows, 1], td[rows, 1] = theta_e_tie(p[rows, 0], t[rows, 0],
                                              td[rows, 0])
    return p, t, td


# Inputs the plain ops take and the most-unstable kernel does not, made
# what it takes by parcels.from_most_unstable_parcel on the card.
MU_INPUTS = ('mixed dtypes', 'broadcast temperature', 'tensor depth',
             'column depths', 'half')


def mu_inputs(case, device='cpu'):
    """Plain soundings of ``mu_columns`` (no constructed tie), 40 of 35
    levels, and a depth, in the form ``case`` of ``MU_INPUTS``: float64
    pressure over float32 fields, a temperature of one row under a (B, L)
    pressure, a depth as a 0-d CPU tensor, a depth a column, or half
    floats."""
    p, t, td = (x[::MU_KINDS].to(device)
                for x in mu_columns(40 * MU_KINDS, 35, seed=6))
    depth = 250.0
    if case == 'mixed dtypes':
        t, td = t.float(), td.float()
    elif case == 'half':
        p, t, td = p.half(), t.half(), td.half()
    elif case == 'broadcast temperature':
        t = t[:1]
    elif case == 'tensor depth':
        depth = torch.tensor(250.0, dtype=torch.float64)
    elif case == 'column depths':
        depth = torch.linspace(100.0, 300.0, 40, dtype=torch.float64,
                               device=device)
    return p, t, td, depth


def theta_e_tie(p, t, td, reach=24):
    """For each (p, t, td), another (t, td) at the same p, each within
    ``reach`` steps of a few ulps, whose theta-e (thermo's, on their
    device) equals theirs exactly; where none does, the one nearest."""
    step = 256 * torch.finfo(t.dtype).eps
    j = torch.arange(-reach, reach + 1, device=t.device, dtype=t.dtype)
    dt, dd = (x.reshape(-1) * step for x in torch.meshgrid(j, j,
                                                           indexing='ij'))
    other = (dt != 0) | (dd != 0)
    dt, dd = dt[other], dd[other]
    want = thermo.equivalent_potential_temperature(p, t, td)
    tc, dc = t[:, None] + dt, td[:, None] + dd
    got = thermo.equivalent_potential_temperature(p[:, None], tc, dc)
    pick = (got - want[:, None]).abs().argmin(-1, keepdim=True)
    return tc.gather(1, pick)[:, 0], dc.gather(1, pick)[:, 0]


def mu_work(p, t):
    """Bytes the most-unstable kernel needs: t and td read once, the
    pressure once (one row where every row is that row), three fields and
    three parcel values written once."""
    B, L = t.shape
    item = t.element_size()
    rows = 1 if B > 1 and p.stride(0) == 0 else B
    return item * (2 * B * L + rows * L + 3 * B * (L + 1)), 0


def cell_columns(name, device, seed=1):
    """A device cell's columns of one time step, as ``parcelbench`` makes
    them from ``seed`` for the cell of deployment ``name`` (the ensemble's:
    one chunk of five members): the pipeline's input dict of (B, L)
    tensors, and the cell's ``ignore_nans``."""
    from parcelbench.data.columns import make_fields
    from parcelbench.entries import device as entry, device_chunked
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, 'parcelbench', 'configs',
                           f'{name}.json')) as f:
        cfg = json.load(f)
    if name == 'gencast_ens50_pl13':
        dat = device_chunked._ensemble(cfg, seed, 0, 5, device)
    else:
        dat = entry._columns(make_fields(cfg, seed, 0, device), cfg)
    return dat, bool(cfg['ignore_nans'])


def span_card_ms(run):
    """Card milliseconds of one call of ``run``, after a warm-up call, by
    the innermost ``xparcel.*`` span that launched each kernel ('-' for
    none): ``torch.profiler``'s trace, each kernel matched to its launch by
    correlation id."""
    run()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix='chip_smoke_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    spans, launched, kernels = [], {}, []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        cat = str(ev.get('cat', '')).lower()
        name = str(ev.get('name', ''))
        corr = (ev.get('args') or {}).get('correlation')
        a = float(ev['ts'])
        if cat == 'user_annotation' and name.startswith('xparcel.'):
            spans.append((a, a + float(ev['dur']), name))
        elif cat == 'cuda_runtime' and name.startswith('cudaLaunchKernel'):
            launched[corr] = a
        elif cat == 'kernel':
            kernels.append((corr, float(ev['dur'])))
    out = {}
    for corr, dur in kernels:
        t = launched.get(corr)
        inner = [sp for sp in spans if t is not None and sp[0] <= t < sp[1]]
        name = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else '-'
        out[name] = out.get(name, 0.0) + dur * 1e-3
    return out


# The mixed-layer kernel's parcels against its twin's, as shares of
# max(|twin|, 1): the sums add their terms in another order.
MIX_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# In float32 the kernel is held to the twin in float64 on the same inputs:
# within MIX_TOL of the scale and MIX_ROUNDING times the float32 twin's own
# distance from it.  Where the float32 sums are ill-conditioned (terms that
# cancel: layers reaching 0 hPa, unsorted levels) both fall far from the
# float64 twin; on the card the kernel's excess over MIX_TOL was at most
# 1.24 times the float32 twin's distance (chip_smoke.mix_columns' hard rows
# at 2 to 137 levels, both depths, the three device cells' columns and
# phase 15's adversarial columns), and 2 leaves room above that reading.
MIX_ROUNDING = 2.0


def mix_exact(p, t, td, depths):
    """What ``compare_mix`` takes as ``exact`` for these inputs: the twin's
    outputs in float64 on them, or None where they are float64."""
    if t.dtype == torch.float64:
        return None
    return parcels._mix_layers_twin(p.double(), t.double(), td.double(),
                                    depths)


def compare_mix(name, got, want, depths, exact=None):
    """Hold the mixed-layer kernel's outputs to its twin's (each the flat
    tuple of ``parcels._mix_layers_twin``): every NaN where the twin's;
    each depth's field pressure, the parcel's pressure and the field
    temperature and dewpoint outside the parcel's slot bit for bit; in the
    slot the parcel's own values; the parcel's temperature and dewpoint
    within ``MIX_TOL`` of the scale of the twin's, or, where ``exact`` (the
    twin's outputs in float64 on the same inputs; to be given in float32)
    is given, within ``MIX_TOL`` of the scale and ``MIX_ROUNDING`` times
    the twin's distance from ``exact`` of ``exact``.  Returns the largest
    share of the scale between kernel and twin; raises on a miss."""
    tol = MIX_TOL[got[0].dtype]
    worst = 0.0
    for i, depth in enumerate(depths):
        g = got[6 * i:6 * i + 6]
        w = want[6 * i:6 * i + 6]
        label = f'{name} depth {depth}'
        same_bits(f'{label} pressure', (g[0], g[3]), (w[0], w[3]))
        slot = w[0] == w[3][..., None]
        same_bits(f'{label} fields off the slot', (g[1][~slot], g[2][~slot]),
                  (w[1][~slot], w[2][~slot]))
        for k in (1, 2):
            same_bits(f'{label} slot', (g[k][slot],),
                      (g[k + 3][..., None].expand_as(g[k])[slot],))
        for k in (4, 5):
            a, b = g[k], w[k]
            na, nb = torch.isnan(a), torch.isnan(b)
            if not torch.equal(na, nb):
                raise AssertionError(f'{label} parcel: NaN patterns differ '
                                     f'in {int((na != nb).sum())} places')
            a, b = a[~na].double(), b[~nb].double()
            scale = b.abs().clamp(min=1.0)
            rel = (a - b).abs() / scale
            worst = max(worst, rel.max().item() if rel.numel() else 0.0)
            if exact is None:
                off, allowed = rel, torch.full_like(rel, tol)
            else:
                x = exact[6 * i + k][~nb]
                off = (a - x).abs() / scale
                allowed = tol + MIX_ROUNDING * (b - x).abs() / scale
            if not (off <= allowed).all():
                j = int((off - allowed).argmax())
                raise AssertionError(f'{label} parcel: {off[j].item():.3g} '
                                     f'of scale > {allowed[j].item():.3g}')
    return worst


def same_bits(name, got, want):
    """Hold each tensor of ``got`` to ``want``'s bit for bit, NaN where it
    is NaN; raises on a miss."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f'{name}[{i}]: {a.dtype} {tuple(a.shape)} '
                                 f'vs {b.dtype} {tuple(b.shape)}')
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            raise AssertionError(f'{name}[{i}]: NaN patterns differ in '
                                 f'{int((na != nb).sum())} places')
        ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[
            a.element_size()]
        off = int((a[~na].view(ints) != b[~nb].view(ints)).sum())
        if off:
            raise AssertionError(f'{name}[{i}]: {off} values differ')


def neighbor_inputs(B, L, broadcast, device, seed=31):
    """A device cell's neighbours inputs, float32 (pressure, valid), each
    (B, L).  ``broadcast``: isobaric levels from 1000 hPa, the (B, L)
    broadcast of one row as the ERA5 and ensemble cells hand it, each
    column's levels below its surface pressure not valid; else
    terrain-following columns from each surface pressure, contiguous, every
    level valid, as in the Aus400 cell."""
    g = torch.Generator(device=device).manual_seed(seed)
    ps = 700.0 + 350.0 * torch.rand(B, generator=g, device=device)
    if broadcast:
        levels = torch.linspace(1000.0, 3.0 if L > 13 else 50.0, L,
                                device=device)
        return levels.expand(B, L), levels <= ps[:, None]
    p = ps[:, None] * torch.linspace(1.0, 0.12, L, device=device)
    return p, torch.isfinite(p)


def neighbors_work(p, valid):
    """Bytes the neighbours kernel needs: the pressure read once (one row
    where every row is that row), the mask once, prev and next written
    once; it does no arithmetic."""
    B, L = valid.shape
    item = p.element_size()
    rows = 1 if B > 1 and p.stride(0) == 0 else B
    return rows * L * item + B * L + 2 * B * L * item, 0


def grid_dataset(dat_np, td, grid, pressure_1d=False):
    """The synthetic soundings as a host Dataset laid out as model output
    is: level variables (level, y, x) with the level dim leading, surface
    winds (y, x), a ``dewpoint`` variable beside the pipeline's inputs, and
    y/x coordinates.  ``pressure_1d``: pressure as a 1-D coordinate
    variable over the level dim (the synthetic columns share one)."""
    ny, nx = grid
    n = ny * nx
    V = xapi.DEFAULT_VERT_DIM

    def level(a):
        return ((V, 'y', 'x'), np.ascontiguousarray(
            a[:n].reshape(ny, nx, -1).transpose(2, 0, 1)))

    data = {k: level(v) if v.ndim == 2 else (('y', 'x'),
                                             v[:n].reshape(ny, nx))
            for k, v in dat_np.items()}
    data['dewpoint'] = level(td)
    if pressure_1d:
        data['pressure'] = ((V,), np.ascontiguousarray(
            dat_np['pressure'][0]))
    return xapi.xr.Dataset(data, coords={
        'y': np.linspace(-40.0, 40.0, ny), 'x': np.linspace(0.0, 359.0, nx)})


def same_as_tensors(name, ds, want, n=None):
    """Hold every variable of the Dataset ``ds`` to the tensor-level
    outputs ``want`` (dict of (B,) tensors; the first ``n`` columns):
    the same names, bit-equal values with NaNs in the same places, and
    attrs and the y/x coordinates on every variable's Dataset."""
    if set(ds.data_vars) != set(want):
        raise AssertionError(f'{name}: variables {sorted(ds.data_vars)} vs '
                             f'{sorted(want)}')
    for k, v in want.items():
        got = np.asarray(ds[k].values).reshape(-1)
        ref = v[:n].cpu().numpy()
        if got.dtype != ref.dtype or not np.array_equal(
                got, ref, equal_nan=ref.dtype.kind == 'f'):
            raise AssertionError(f'{name}/{k}: differs from the tensor-level '
                                 f'path ({got.dtype} vs {ref.dtype})')
        if ds[k].dims != ('y', 'x') or not ds[k].attrs:
            raise AssertionError(f'{name}/{k}: dims {ds[k].dims}, attrs '
                                 f'{ds[k].attrs}')
    if 'y' not in ds.coords or 'x' not in ds.coords:
        raise AssertionError(f'{name}: coordinates {list(ds.coords)}')


def finite_sum(out, keys):
    """Sum of the outputs ``keys`` of ``out``, each weighted by its place
    in ``keys`` (1, 2, ...), with non-finite entries dropped: the scalar
    the gradient checks differentiate."""
    return sum((i + 1) * torch.where(torch.isfinite(out[k]), out[k],
                                     0.0).sum()
               for i, k in enumerate(keys))


def repeated_level(pressure):
    """(B,) mask of the columns with a level repeated exactly.  The solve
    is not differentiable there: which one-sided derivative the VJP takes
    at the zero-width gap turns on the last bit of the temperatures, so a
    card's and a CPU's rounding may pick different ones."""
    return (pressure[:, 1:] == pressure[:, :-1]).any(-1).cpu()


def compare_grads(name, got, want, skip=None):
    """Hold float64 gradients (sequences of tensors, batch first) from the
    card against the CPU's: identical NaN patterns everywhere, and abs
    diff <= 1e-6 of each gradient's scale outside the (B,) mask ``skip``.
    Returns the largest relative difference."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().cpu(), b.detach().cpu()
        flips = int((torch.isnan(a) != torch.isnan(b)).sum())
        if flips:
            raise AssertionError(f'{name}[{i}]: NaN patterns differ in '
                                 f'{flips} places')
        scale = max(1.0, b.nan_to_num().abs().max().item())
        if skip is not None:
            a, b = a[~skip], b[~skip]
        rel = ((a - b).nan_to_num().abs().max().item()) / scale
        if not rel <= 1e-6:
            raise AssertionError(f'{name}[{i}]: max |diff| {rel:.3g} of the '
                                 f'scale {scale:.3g}')
        worst = max(worst, rel)
    return worst


def compare(name, got, want, dtype_name):
    """Hold ``got`` against ``want`` (same-shaped tensors or dicts of them):
    float64 to identical NaN patterns and ``F64_ATOL``; float32 to the
    budget.  Returns the largest absolute difference; raises on a miss."""
    if not isinstance(got, dict):
        got, want = {'': got}, {'': want}
    worst = 0.0
    for key in want:
        a = got[key].detach().cpu().double()
        b = want[key].detach().cpu().double()
        if a.shape != b.shape:
            raise AssertionError(f'{name}{key}: shape {tuple(a.shape)} vs '
                                 f'{tuple(b.shape)}')
        if got[key].dtype == torch.bool:
            flips = (a != b).double().mean().item()
            if flips > 0.05:
                raise AssertionError(f'{name}{key}: {flips:.2%} flips')
            continue
        na, nb = torch.isnan(a), torch.isnan(b)
        both = ~na & ~nb
        d = (a - b).abs()[both]
        mx = d.max().item() if d.numel() else 0.0
        worst = max(worst, mx)
        if dtype_name == 'float64':
            if not torch.equal(na, nb):
                raise AssertionError(f'{name}{key}: NaN patterns differ in '
                                     f'{int((na != nb).sum())} places')
            if mx > F64_ATOL:
                raise AssertionError(f'{name}{key}: max |diff| {mx:.3g} > '
                                     f'{F64_ATOL}')
            continue
        flips = (na != nb).double().mean().item()
        if flips > F32_NAN_FLIPS:
            raise AssertionError(f'{name}{key}: {flips:.2%} NaN flips')
        if not d.numel():
            continue
        scale = max(1.0, b[~nb].abs().max().item())
        rel = d / scale
        p95 = torch.quantile(rel, 0.95).item()
        if p95 > F32_P95 or rel.max().item() > F32_MAX:
            raise AssertionError(f'{name}{key}: relative error p95 '
                                 f'{p95:.3g}, max {rel.max().item():.3g} '
                                 f'over the float32 budget')
    return worst


def compare_prepass(name, got, want):
    """Hold the pre-pass's (row, scalars, k0) against the twin's: k0 and
    the NaN patterns equal, the row within ``PREPASS_TOL`` of its largest
    magnitude and each scalar within it of its own.  Returns the largest
    error over scale; raises on a miss."""
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f'{name}: k0 differs')
    tol = PREPASS_TOL[want[0].dtype]
    named = [('row', got[0], want[0])] + [
        (k, got[1][:, i], want[1][:, i]) for i, k in enumerate(fused.SCALARS)]
    worst = 0.0
    for key, a, b in named:
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f'{name}/{key}: NaN patterns differ')
        scale = b.nan_to_num().abs().max().item() or 1.0
        rel = (a - b).nan_to_num().abs().max().item() / scale
        if rel > tol:
            raise AssertionError(f'{name}/{key}: {rel:.3g} of scale > {tol}')
        worst = max(worst, rel)
    return worst


def bound(nbytes, ops, dtype):
    """The least time the card could take for work that moves ``nbytes``
    and does ``ops`` operations of ``dtype``, at the published peaks of
    ``parcelbench.harness.card``: ``(ms, 'bytes' or 'operations')``,
    whichever of the two times is larger."""
    by_bytes = nbytes / card.HBM_BYTES_PER_S * 1e3
    by_ops = ops / card.PEAK_OPS[dtype.itemsize] * 1e3
    return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops,
                                                           'operations')


def solve_work(p, t, td, row, scalars, k0):
    """Bytes and operations the solve needs on these packed arguments:
    each input read once and the seven outputs written once; for each
    spliced slot evaluated (the levels of finite pressure and the LCL's),
    the Clenshaw series (three per coefficient of a segment) and 70 more
    (the log, four exp, five divides and the arithmetic around them, each
    counted as one, and the slot's gap)."""
    nbytes = sum(x.numel() * x.element_size()
                 for x in (p, t, td, row, scalars, k0))
    nbytes += len(fused.OUTPUTS) * p.shape[0] * p.element_size()
    slots = int(torch.isfinite(p).sum()) + p.shape[0]
    return nbytes, slots * (3 * (row.shape[-1] // adiabat.N_SEG) + 70)


def prepass_work(p, k0):
    """Bytes and operations of the pre-pass on these columns: the parcel
    state and the levels up to each column's first finite pressure read
    once, the table once, the row, scalars and k0 written once; about
    1,800 operations a column (30 LCL iterations of 12, 12 RK4 substeps of
    four 22-operation lapse rates and their 16, the row's 4 a coefficient;
    a transcendental counted as one)."""
    B, item = p.shape[0], p.element_size()
    nbytes = item * (3 * B + int(k0.sum()) + B
                     + adiabat.N_CURVES * adiabat.N_COEF
                     + B * (adiabat.N_COEF + len(fused.SCALARS))) + 4 * B
    ops = 30 * 12 + 12 * (4 * 22 + 16) + 4 * adiabat.N_COEF
    return nbytes, B * ops


def tail_work(p, t, td, h):
    """Bytes and operations of the tail on these inputs: four (B, L)
    inputs read once, six (B,) outputs written once; about 30 operations
    per level of finite pressure (its log, three anchor updates, the wet
    bulb and two crossings)."""
    nbytes = 4 * p.numel() * p.element_size()
    nbytes += len(diag.DIAG_OUTPUTS) * p.shape[0] * p.element_size()
    return nbytes, 30 * int(torch.isfinite(p).sum())


def cuda_ms(fn, repeats):
    """Mean device milliseconds of ``fn`` over ``repeats`` launches, after
    one warm-up, and the warm-up's result."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / repeats, out


def wall_median(fn, repeats):
    """Median host seconds of ``fn`` with a device synchronise."""
    secs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs))


def phase_tiers(dev, tab64, tab32, smi, solve_ms, tail_ms, pipeline_rate):
    """Phase 15: the JAX package's acceptance tiers through the kernels.

    Float64 at the tiers' sizes: every tier grid through the kernel path,
    held to the CPU twins and the card's modular path (``hold_tier``), then
    to the serial oracle under the tiers' tolerances and filters.  Float32
    at full width: the five sweep classes at 90 levels, 65,540 distinct
    columns tiled to ``MAIN_COLUMNS``, through ``conv_properties_fused``
    against the card's modular path under the float32 budget, but for the
    mixed parcels' outputs, which are held to a witness: a run with the
    mixed layers' twin in the kernel's place, within the whole budget and
    bit for bit the kernel's run in every other output, and one with the
    twin in float64 rounded to float32, whose count of values past the
    budget's largest share bounds the kernel's; the mixed-layer kernel
    against its twin (``compare_mix``) on the distinct columns; with the
    pipeline's rate and each kernel's time on them beside the synthetic
    columns' (``solve_ms``, ``tail_ms``, ``pipeline_rate``).  Logs the
    phase's lines and returns the (solve, tail) launches of its kernel
    paths."""
    t0 = time.perf_counter()
    held, notes, launches = {}, [], np.zeros(2, int)
    for name in TIER_GRIDS:
        held[name], more, seen = hold_tier(name, tab64, dev)
        notes += more
        launches += seen
    for line in notes:
        log(f'[15 note] {line}')
    hold_s = time.perf_counter() - t0

    # The oracle.  The multicross sets through the solve: the multicross
    # tier's 1 hPa and 1.5 J/kg.
    for kind in ('base', 'deep'):
        out = held[f'multicross/{kind}']['fused_cape_cin']
        check_multicross(f'15 multicross {kind}', multicross_set(kind)[1],
                         out['cape'], out['cin'], out['lfc_pressure'],
                         out['el_pressure'])
    # make_grid's surface solve: the table tier's > 95% of columns on the
    # same LFC branch, CAPE within 1 J/kg or 1% there.
    oracle = serial_oracle()
    grid = [x.reshape(-1, x.shape[-1]) for x in make_grid()]
    ser = np.array([oracle.surface_cape_cin_column(*c) for c in zip(*grid)])
    out = held['make_grid']['fused_surface_cape_cin']
    branch = same_branch(out['lfc_pressure'], ser[:, 2])
    d = np.abs(out['cape'] - ser[:, 0])[branch]
    rel = d / np.maximum(np.abs(ser[:, 0])[branch], 100.0)
    grid_err = float(np.nanmax(np.minimum(d, rel * 100.0)))
    if not (branch.mean() > 0.95 and grid_err < 1.0):
        raise AssertionError(f'15 make_grid: {branch.mean():.0%} on the '
                             f'same branch, CAPE table error {grid_err:.3g}')
    # Two sweep classes: the card's modular path with the exact ODE at the
    # sweep's tolerances, and the fused pipeline at the table tier's (its
    # scalar diagnostics, the tail's, at the sweep's), on the sweep's
    # comparable columns.
    comparable = {}
    for case in ('dup_pressure', 'combined'):
        p, t, td0, h, winds = sweep_columns(case)
        dat, td = sweep_inputs(p, t, td0, h, winds, device=dev)
        vec = sweep_vector(dat, moist_lapse=xt.moist_lapse_integrate)
        ser = sweep_serial(p, t, td, h, winds)
        nan_pmax, dup_p = sweep_records(p)
        out = held[f'sweep/{case}']['conv_properties_fused']
        comparable[case] = []
        for name, _ in SWEEP_PROBES:
            same = sweep_comparable(name, p, vec, ser, nan_pmax, dup_p)
            if not same.mean() > 0.6:
                raise AssertionError(f'15 sweep {case}/{name}: only '
                                     f'{same.mean():.0%} comparable')
            check_sweep_variant(f'15 sweep {case}', name, vec, ser, same)
            check_sweep_variant(f'15 sweep {case} fused', name, out, ser,
                                same, tables=True)
            comparable[case].append(int(same.sum()))
        check_sweep_scalars(f'15 sweep {case}', vec, ser, nan_pmax)
        check_sweep_scalars(f'15 sweep {case} fused', out, ser, nan_pmax)
    f64_s = time.perf_counter() - t0
    log(f'[15 tiers float64] {len(TIER_GRIDS)} tier grids ('
        f'{", ".join(TIER_GRIDS)}) through the kernels on the card, launches '
        f'(3, 1) per conv_properties_fused, (1, 1) per '
        f'min_conv_properties_fused, (1, 0) per solve: equal to the CPU '
        f'twins and to the card\'s modular path (NaN and boolean patterns '
        f'identical, values within 1e-10 of scale; {len(notes)} outputs '
        f'held to {F64_ATOL} instead, each printed above); serial oracle: '
        f'multicross base and deep sets within 1 hPa and 1.5 J/kg, '
        f'make_grid CAPE within {grid_err:.3g} J/kg of the table tier\'s 1 '
        f'({branch.mean():.0%} on the same branch), sweep dup_pressure and '
        f'combined at the sweep\'s tolerances (modular, exact ODE) and the '
        f'table tier\'s (fused) on {comparable} comparable columns '
        f'(mu, m100, m50); {hold_s:.1f} s holding, {f64_s:.1f} s in all')

    # Float32 at full width.
    t1 = time.perf_counter()
    per = -(-65_536 // len(SWEEP_CASES))
    cols = [sweep_columns(case, n=per, L=LEVELS) for case in SWEEP_CASES]
    p, t, td0, h = (np.concatenate([c[i] for c in cols]) for i in range(4))
    winds = {k: np.concatenate([c[4][k] for c in cols]) for k in cols[0][4]}
    small, _ = sweep_inputs(p, t, td0, h, winds, dtype=torch.float32,
                            device=dev)
    distinct = p.shape[0]
    idx = torch.arange(MAIN_COLUMNS, device=dev) % distinct
    dat = {k: v[idx].contiguous() for k, v in small.items()}
    del small

    def pipeline():
        return xt.conv_properties_fused(dat, tables=tab32, ignore_nans=True)
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    got = pipeline()
    torch.cuda.synchronize()
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (3, 1):
        raise AssertionError(f'15 float32: (solve, tail) launches {counts}')
    launches += counts
    want = xt.conv_properties(dat, tables=tab32, ignore_nans=True)
    # The mixed-layer kernel's parcels differ from its twin's (the modular
    # path's torch ops) in the order their sums add, and the mixed parcels'
    # CAPE and CIN on these columns' knife edges move with a parcel's last
    # bits.  So the pipeline runs twice more with the kernel's twin in its
    # place: as it is (held to the modular path under the whole budget),
    # and in float64 with its parcels rounded to float32, a witness of how
    # many values a parcel's last bits alone move past the budget.
    def with_mix(mix):
        kernel = parcels.mix_layers_kernel
        parcels.mix_layers_kernel = mix
        try:
            return pipeline()
        finally:
            parcels.mix_layers_kernel = kernel

    def rounded(p, t, td, depths):
        return tuple(x.float() for x in mix_exact(p, t, td, depths))

    same = with_mix(parcels._mix_layers_twin)
    witness = with_mix(rounded)
    compare('15 adversarial float32 twin/', same, want, 'float32')
    mixed = [k for k in want if k.startswith('mixed_')]
    rest = [k for k in want if k not in mixed]
    # With the kernel: every output that reads no mixed parcel within the
    # budget and bit for bit the twin's, every NaN where the twin's.
    f32_err = compare('15 adversarial float32/', {k: got[k] for k in rest},
                      {k: want[k] for k in rest}, 'float32')
    for k in rest:
        if want[k].dtype == torch.bool:
            if not torch.equal(got[k], same[k]):
                raise AssertionError(f'15 float32 {k}: kernel vs twin flips')
        else:
            same_bits(f'15 float32 {k} kernel vs twin', (got[k],), (same[k],))
    # The mixed parcels' outputs: NaN where the twin's, the budget's 95th
    # percentile, and no more values past its largest share than twice
    # the witness's.
    beyond, seen = {}, {}
    for k in mixed:
        v = want[k]
        if not torch.equal(torch.isnan(got[k]), torch.isnan(same[k])):
            raise AssertionError(f'15 float32 {k}: NaN patterns of kernel '
                                 f'and twin differ')
        both = ~torch.isnan(got[k]) & ~torch.isnan(v)
        scale = max(1.0, v[~torch.isnan(v)].abs().max().item())
        rel = (got[k] - v).abs()[both] / scale
        if rel.numel() and torch.quantile(rel, 0.95).item() > F32_P95:
            raise AssertionError(f'15 float32 {k}: relative error p95 over '
                                 f'the float32 budget')
        beyond[k] = int((rel > F32_MAX).sum())
        seen[k] = int(((witness[k] - v).abs()[both] / scale > F32_MAX).sum())
    if sum(beyond.values()) > 2 * sum(seen.values()):
        raise AssertionError(f'15 float32: the kernel moves {beyond} values '
                             f'past the budget, the witness {seen}')
    flips = {k: float((torch.isnan(got[k]) != torch.isnan(want[k])).double()
                      .mean()) for k in got if got[k].dtype != torch.bool}
    n_cape = int(torch.isfinite(got['mu_cape']).sum())
    del got, want, same, witness
    rate = MAIN_COLUMNS / wall_median(pipeline, 5)
    bp, bt = dat['pressure'], dat['temperature']
    btd = thermo.dewpoint_from_specific_humidity(bp, bt,
                                                 dat['specific_humidity'])
    depths = (100.0, 50.0)
    cols = tuple(x[:distinct] for x in (bp, bt, btd))
    mix_err = compare_mix(
        '15 adversarial float32 mixed layers',
        parcels.mix_layers_kernel(*cols, depths),
        parcels._mix_layers_twin(*cols, depths), depths,
        mix_exact(*cols, depths))
    for depth in MU_DEPTHS:
        same_bits(f'15 adversarial float32 most-unstable {depth}',
                  parcels.most_unstable_kernel(*cols, depth),
                  parcels._most_unstable_twin(*cols, depth))
    del cols
    margs = tuple(x.contiguous() for x in (
        bp, bt, btd, *fused.prepass(bp, bp[:, 0], bt[:, 0], btd[:, 0],
                                    tab32)))
    adv_solve_ms, _ = cuda_ms(lambda: fused.cape_cin_kernel(*margs), 10)
    del margs
    targs = tuple(x.contiguous() for x in (bp, bt, btd, dat['height_asl']))
    adv_tail_ms, _ = cuda_ms(lambda: diag.diag_kernel(*targs), 10)
    del targs, dat
    worst = max(flips, key=flips.get)
    log(f'[15 tiers float32] the five sweep classes at {LEVELS} levels, '
        f'{distinct} distinct adversarial columns tiled to {MAIN_COLUMNS}: '
        f'conv_properties_fused (launches 3+1) within the float32 budget '
        f'of the card\'s modular path (max |diff| {f32_err:.3g}; most NaN '
        f'flips {flips[worst]:.2%} in {worst}; mu_cape finite in {n_cape} '
        f'columns) but for the mixed parcels\' outputs, and bit for bit the '
        f'pipeline with the mixed layers\' twin there, which is within the '
        f'whole budget; the mixed-layer kernel within {mix_err:.3g} of scale '
        f'of its twin, the most-unstable kernel bit for bit its twin at '
        f'depths {MU_DEPTHS}; the mixed parcels\' outputs NaN where the '
        f'twin\'s, '
        f'{sum(beyond.values())} values of {MAIN_COLUMNS} x {len(beyond)} '
        f'beyond the budget\'s largest share ('
        + ', '.join(f'{k} {n}' for k, n in beyond.items() if n)
        + f') against the float64-rounded witness\'s '
        f'{sum(seen.values())} ('
        + ', '.join(f'{k} {n}' for k, n in seen.items() if n)
        + f'); {rate:.4g} columns/s against phase 5\'s '
        f'{pipeline_rate:.4g} on the synthetic columns; solve kernel '
        f'{adv_solve_ms:.3f} ms against {solve_ms:.3f}, tail kernel '
        f'{adv_tail_ms:.3f} ms against {tail_ms:.3f} (CUDA events, '
        f'adversarial against synthetic); {time.perf_counter() - t1:.1f} s; '
        f'{smi}')
    return tuple(int(n) for n in launches)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this script '
              'runs only on a CUDA GPU', file=sys.stderr)
        return 1

    # 1. Device.
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f'[1 device] {torch.cuda.get_device_name(0)}, '
        f'{torch.cuda.device_count()} card(s), torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}')
    log(smi)

    # 2. Kernel library: every kernel, one nvcc per source.
    path, build_s = _build.build(verbose=True)
    _build.load_library()
    log(f'[2 build] {path} in {build_s:.2f} s (0.00 = already built)')

    # 3. Coefficients, built on the card in float64.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab64 = xt.AdiabatTables.build(dev, torch.float64)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    tab32 = xt.AdiabatTables(tab64.coeffs.to(torch.float32))
    if not torch.isfinite(tab64.coeffs).all():
        raise AssertionError('non-finite spectral coefficients')
    # The same build on the host: the CPU tests hold it against the JAX
    # package's coefficients.
    host = adiabat.build_spectral('cpu')
    fit_err = (tab64.coeffs.cpu() - host).abs().max().item()
    if not fit_err <= 1e-9:
        raise AssertionError(f'card-built coefficients off the host build '
                             f'by {fit_err:.3g}')
    log(f'[3 tables] coeffs {tuple(tab64.coeffs.shape)} built on the card in '
        f'{tables_s:.2f} s; max |card - host build| {fit_err:.2e}')

    # 4. Each kernel against its plain twin on the card.
    errs, tail_errs = {}, {}
    p_np, t_np, td_np = hard_columns(HARD_COLUMNS)
    tail_np = tail_columns(TAIL_COLUMNS)
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split('.')[-1]
        tab = tab64 if dtype == torch.float64 else tab32
        cols = [torch.as_tensor(x, dtype=dtype, device=dev)
                for x in (p_np, t_np, td_np)]
        args = kernel_args(*cols, tab)
        got = fused.cape_cin_kernel(*args)
        got_p, prof = fused.cape_cin_kernel(*args, with_profile=True)
        torch.cuda.synchronize()
        want, want_prof = fused._column_outputs(*args, with_profile=True)
        errs[dname] = compare(f'kernel/{dname}/',
                              dict(zip(fused.OUTPUTS, got)),
                              dict(zip(fused.OUTPUTS, want)), dname)
        if not torch.equal(got.nan_to_num(7.0), got_p.nan_to_num(7.0)):
            raise AssertionError(f'kernel/{dname}: outputs differ with and '
                                 f'without the profile tracks')
        prof_err = compare(f'kernel/{dname}/profile/',
                           dict(zip(fused.PROFILE, prof)),
                           dict(zip(fused.PROFILE, want_prof)), dname)
        li = diag.lifted_index(dict(zip(fused.PROFILE, prof)))
        li_err = compare(f'kernel/{dname}/profile LI/', li['lifted_index'],
                         got[fused.OUTPUTS.index('lifted_index')], dname)
        gp = torch.tensor([[959., 779.2, 751.3, 724.3, 700., 269.]],
                          dtype=dtype, device=dev)
        gt = torch.tensor([[22.2, 14.6, 12., 9.4, 7., -38.]], dtype=dtype,
                          device=dev) + 273.15
        gd = torch.tensor([[19., -11.2, -10.8, -10.4, -10., -53.2]],
                          dtype=dtype, device=dev) + 273.15
        res, _ = xt.fused_surface_cape_cin(gp, gt, gd, tables=tab)
        cape, cin = res['cape'].item(), res['cin'].item()
        if (abs(cape - GOLDEN['cape']) > GOLDEN['tol']
                or abs(cin - GOLDEN['cin']) > GOLDEN['tol']):
            raise AssertionError(f'golden sounding {dname}: cape {cape:.3f}, '
                                 f'cin {cin:.3f}')
        log(f'[4 kernel {dname}] {args[0].shape[0]} columns x {LEVELS} vs '
            f'plain twin: max |diff| {errs[dname]:.3g}; profile tracks '
            f'{prof_err:.3g}, LI from them vs in-kernel LI {li_err:.3g}; '
            f'golden cape {cape:.3f} cin {cin:.3f}')

        tail = [torch.as_tensor(x, dtype=dtype, device=dev) for x in tail_np]
        got = diag.diag_kernel(*tail)
        torch.cuda.synchronize()
        tail_errs[dname] = compare(
            f'tail/{dname}/', dict(zip(diag.DIAG_OUTPUTS, got)),
            dict(zip(diag.DIAG_OUTPUTS, diag._diag_body(*tail))), dname)
        log(f'[4 tail {dname}] {TAIL_COLUMNS} hard columns x {LEVELS} vs '
            f'plain twin: max |diff| {tail_errs[dname]:.3g}')

        # Other widths, with the hard cases across the lanes' wrap.
        for L in EDGE_LEVELS:
            args = lane_edge_args(EDGE_COLUMNS, tab, L=L)
            got, prof = fused.cape_cin_kernel(*args, with_profile=True)
            torch.cuda.synchronize()
            want, want_prof = fused._column_outputs(*args, with_profile=True)
            err = max(compare(f'kernel/{dname}/L={L}/',
                              dict(zip(fused.OUTPUTS, got)),
                              dict(zip(fused.OUTPUTS, want)), dname),
                      compare(f'kernel/{dname}/L={L}/profile/',
                              dict(zip(fused.PROFILE, prof)),
                              dict(zip(fused.PROFILE, want_prof)), dname))
            tail = [torch.as_tensor(x, dtype=dtype, device=dev)
                    for x in lane_edge_tail_columns(EDGE_COLUMNS, L=L)]
            got = diag.diag_kernel(*tail)
            torch.cuda.synchronize()
            terr = compare(f'tail/{dname}/L={L}/',
                           dict(zip(diag.DIAG_OUTPUTS, got)),
                           dict(zip(diag.DIAG_OUTPUTS, diag._diag_body(*tail))),
                           dname)
            errs[dname] = max(errs[dname], err)
            tail_errs[dname] = max(tail_errs[dname], terr)
            log(f'[4 lanes {dname} L={L}] {args[0].shape[0]} solve and '
                f'{EDGE_COLUMNS} tail columns with the hard cases across '
                f'lanes 31/32 and 63/64 vs plain twins: solve and tracks '
                f'max |diff| {err:.3g}, tail {terr:.3g}')

    # Kernels and twins timed at the main path's shape, in turns.
    dat_np, td_main = synthetic(MAIN_COLUMNS)
    p, t, h = (torch.as_tensor(dat_np[k], device=dev)
               for k in ('pressure', 'temperature', 'height_asl'))
    td = torch.as_tensor(td_main, device=dev)
    # Contiguous, as the kernels take them: the synthetic pressure is
    # column-major, and the wrappers' copy would be timed with the kernel.
    margs = tuple(x.contiguous() for x in (
        p, t, td, *fused.prepass(p, p[:, 0], t[:, 0], td[:, 0], tab32)))
    # The timed outputs of each side are held against each other: every
    # block of the full grid, its ragged edge included.
    plain_a, want = cuda_ms(lambda: fused._column_outputs(*margs), 3)
    kern_a, got = cuda_ms(lambda: fused.cape_cin_kernel(*margs), 10)
    prof_ms, _ = cuda_ms(lambda: fused.cape_cin_kernel(*margs,
                                                       with_profile=True), 10)
    flags_ms, _ = cuda_ms(lambda: fused.cape_cin_kernel(
        *margs, **SOLVE_OPTIONS[-1]), 10)
    kern_b, _ = cuda_ms(lambda: fused.cape_cin_kernel(*margs), 10)
    plain_b, _ = cuda_ms(lambda: fused._column_outputs(*margs), 3)
    kernel_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    full_err = compare('kernel/main shape/', dict(zip(fused.OUTPUTS, got)),
                       dict(zip(fused.OUTPUTS, want)), 'float32')
    solve_bound = bound(*solve_work(*margs), torch.float32)
    log(f'[4 timing] {MAIN_COLUMNS} x {LEVELS} float32: kernel '
        f'{kern_a:.3f}/{kern_b:.3f} ms ({prof_ms:.3f} ms with the profile '
        f'tracks), plain twin {plain_a:.3f}/{plain_b:.3f} ms, bound '
        f'{solve_bound[0]:.3f} ms by {solve_bound[1]} ({smi}); '
        f'kernel vs twin there within the float32 budget, max |diff| '
        f'{full_err:.3g}')
    del margs, got, want
    # The pre-pass, kernel against plain twin, on the surface parcels.
    pc = p.contiguous()
    pargs = (pc, *(x[:, 0].contiguous() for x in (pc, t, td)))
    pplain_a, want = cuda_ms(lambda: fused._prepass_twin(*pargs, tab32), 3)
    pkern_a, got = cuda_ms(lambda: fused.prepass_kernel(*pargs, tab32), 10)
    pkern_b, _ = cuda_ms(lambda: fused.prepass_kernel(*pargs, tab32), 10)
    pplain_b, _ = cuda_ms(lambda: fused._prepass_twin(*pargs, tab32), 3)
    prepass_ms = (pkern_a + pkern_b) / 2
    prepass_err = compare_prepass('prepass/main shape', got, want)
    prepass_bound = bound(*prepass_work(pargs[0], got[2]), torch.float32)
    log(f'[4 timing] pre-pass {MAIN_COLUMNS} columns float32: kernel '
        f'{pkern_a:.3f}/{pkern_b:.3f} ms, plain twin {pplain_a:.3f}/'
        f'{pplain_b:.3f} ms, bound {prepass_bound[0]:.3f} ms by '
        f'{prepass_bound[1]} ({smi}); k0 and NaN patterns equal, rows and '
        f'scalars within {prepass_err:.3g} of scale')
    del pargs, pc, got, want
    # The neighbours (parcels.bridge_neighbors): kernel against plain twin
    # bit for bit, and the two library scans alone on inputs masked
    # beforehand, at the device cells' shapes.
    nb_rows = {}
    for label, B, L, broadcast in NEIGHBOR_SHAPES:
        np_, nv = neighbor_inputs(B, L, broadcast, dev)
        lo = torch.where(nv, np_, torch.inf)
        hi = torch.where(nv, np_, -torch.inf).flip(-1).contiguous()

        def scans():
            return torch.cummin(lo, -1), torch.cummax(hi, -1)

        ntwin_a, want = cuda_ms(
            lambda: parcels._bridge_neighbors_twin(np_, nv), 3)
        nkern_a, got = cuda_ms(
            lambda: parcels.bridge_neighbors_kernel(np_, nv), 10)
        nlib_a, _ = cuda_ms(scans, 3)
        nlib_b, _ = cuda_ms(scans, 3)
        nkern_b, _ = cuda_ms(
            lambda: parcels.bridge_neighbors_kernel(np_, nv), 10)
        ntwin_b, _ = cuda_ms(
            lambda: parcels._bridge_neighbors_twin(np_, nv), 3)
        same_bits(f'neighbors/{label}', got, want)
        nb_bound = bound(*neighbors_work(np_, nv), torch.float32)
        nb_rows[label] = {
            'columns': B, 'levels': L, 'broadcast': broadcast,
            'ms': (nkern_a + nkern_b) / 2, 'plain_ms': (ntwin_a + ntwin_b) / 2,
            'library_ms': (nlib_a + nlib_b) / 2, 'bound_ms': nb_bound[0],
            'bound_by': nb_bound[1]}
        log(f'[4 neighbors {label}] {B} x {L} float32 '
            f'{"broadcast" if broadcast else "contiguous"} pressure: kernel '
            f'{nkern_a:.3f}/{nkern_b:.3f} ms, plain twin {ntwin_a:.3f}/'
            f'{ntwin_b:.3f} ms, torch.cummin + torch.cummax alone '
            f'{nlib_a:.3f}/{nlib_b:.3f} ms, bound {nb_bound[0]:.3f} ms by '
            f'{nb_bound[1]} ({smi}); bit-equal with the twin')
        del np_, nv, lo, hi, got, want
    # The mixed layers (parcels.mix_layers): kernel against plain twin on
    # the hard rows in both dtypes; then at the device cells' shapes on
    # each cell's own columns, timed against the twin and the bound, and
    # each cell's pipeline call split by span, with the kernel and with
    # the twin (the composition it replaced) in its place.
    mix_depths = (100.0, 50.0)
    mix_err = {}
    for dtype in (torch.float64, torch.float32):
        for L in (13, 35, 90):
            cols = mix_columns(MIX_COLUMNS, L, seed=L, dtype=dtype,
                               device=dev)
            got = parcels.mix_layers_kernel(*cols, mix_depths)
            torch.cuda.synchronize()
            mix_err[(dtype, L)] = compare_mix(
                f'mix/{dtype}/L={L}', got,
                parcels._mix_layers_twin(*cols, mix_depths), mix_depths,
                mix_exact(*cols, mix_depths))
    log(f'[4 mixed layers] {MIX_COLUMNS} hard rows x 13, 35 and 90 levels '
        f'vs plain twin: fields and parcel pressure bit-equal; slot and '
        f'parcel t and td within ' + ', '.join(
            f'{v:.3g}' for v in mix_err.values()) + ' of scale (float64, '
        f'then float32, held to the float64 twin)')
    mix_rows = {}
    for label, B, L, broadcast in NEIGHBOR_SHAPES:
        dat, ignore = cell_columns(label, dev)
        mp, mt = dat['pressure'], dat['temperature']
        if mt.shape != (B, L) or (mp.stride(0) == 0) != broadcast:
            raise AssertionError(f'{label}: columns {tuple(mt.shape)}')
        margs = (mp, mt, thermo.dewpoint_from_specific_humidity(
            mp, mt, dat['specific_humidity']), mix_depths)
        mtwin_a, want = cuda_ms(lambda: parcels._mix_layers_twin(*margs), 3)
        mkern_a, got = cuda_ms(lambda: parcels.mix_layers_kernel(*margs), 10)
        mkern_b, _ = cuda_ms(lambda: parcels.mix_layers_kernel(*margs), 10)
        mtwin_b, _ = cuda_ms(lambda: parcels._mix_layers_twin(*margs), 3)
        err = compare_mix(f'mix/{label}', got, want, mix_depths,
                          mix_exact(*margs))
        mb = bound(*mix_work(mp, mt, mix_depths), torch.float32)
        mix_rows[label] = {
            'columns': B, 'levels': L, 'broadcast': broadcast,
            'ms': (mkern_a + mkern_b) / 2, 'plain_ms': (mtwin_a + mtwin_b) / 2,
            'bound_ms': mb[0], 'bound_by': mb[1], 'max_rel_err': err}
        log(f'[4 mixed layers {label}] {B} x {L} float32 '
            f'{"broadcast" if broadcast else "contiguous"} pressure, the '
            f'cell\'s columns, depths {mix_depths}: kernel {mkern_a:.3f}/'
            f'{mkern_b:.3f} ms, plain twin {mtwin_a:.3f}/{mtwin_b:.3f} ms, '
            f'bound {mb[0]:.3f} ms by {mb[1]} ({smi}); parcels within '
            f'{err:.3g} of scale')
        del got, want, dat, margs, mp, mt
    # The most-unstable prep (parcels.from_most_unstable_parcel): kernel
    # against plain twin, bit for bit, on the hard rows in both dtypes at
    # both depths; then at the device cells' shapes on each cell's own
    # columns, timed against the twin and the bound, and each cell's
    # pipeline call split by span, with the kernel and with the twin (the
    # composition it replaced) in its place.
    for dtype in (torch.float64, torch.float32):
        for L in MU_LEVELS:
            cols = mu_columns(MU_COLUMNS, L, seed=L, dtype=dtype, device=dev)
            for depth in MU_DEPTHS:
                same_bits(f'most-unstable/{dtype}/L={L}/{depth}',
                          parcels.most_unstable_kernel(*cols, depth),
                          parcels._most_unstable_twin(*cols, depth))
            del cols
    log(f'[4 most-unstable] {MU_COLUMNS} hard rows x {MU_LEVELS} levels, '
        f'depths {MU_DEPTHS}, float64 and float32: fields and parcel '
        f'bit-equal with the plain twin')
    mu_rows, span_rows = {}, {}
    for label, B, L, broadcast in NEIGHBOR_SHAPES:
        dat, ignore = cell_columns(label, dev)
        up, ut = dat['pressure'], dat['temperature']
        uargs = (up, ut, thermo.dewpoint_from_specific_humidity(
            up, ut, dat['specific_humidity']), 250.0)
        utwin_a, want = cuda_ms(lambda: parcels._most_unstable_twin(*uargs),
                                3)
        ukern_a, got = cuda_ms(lambda: parcels.most_unstable_kernel(*uargs),
                               10)
        ukern_b, _ = cuda_ms(lambda: parcels.most_unstable_kernel(*uargs),
                             10)
        utwin_b, _ = cuda_ms(lambda: parcels._most_unstable_twin(*uargs), 3)
        same_bits(f'most-unstable/{label}', got, want)
        ub = bound(*mu_work(up, ut), torch.float32)
        mu_rows[label] = {
            'columns': B, 'levels': L, 'broadcast': broadcast,
            'ms': (ukern_a + ukern_b) / 2, 'plain_ms': (utwin_a + utwin_b) / 2,
            'bound_ms': ub[0], 'bound_by': ub[1], 'bit_equal': True}
        log(f'[4 most-unstable {label}] {B} x {L} float32 '
            f'{"broadcast" if broadcast else "contiguous"} pressure, the '
            f'cell\'s columns, depth 250: kernel {ukern_a:.3f}/'
            f'{ukern_b:.3f} ms, plain twin {utwin_a:.3f}/{utwin_b:.3f} ms, '
            f'bound {ub[0]:.3f} ms by {ub[1]} ({smi}); bit-equal with the '
            f'twin')
        del got, want

        def pipe():
            return xt.conv_properties_fused(dat, ignore_nans=ignore,
                                            tables=tab32)

        after = span_card_ms(pipe)
        kernel = parcels.most_unstable_kernel
        parcels.most_unstable_kernel = parcels._most_unstable_twin
        try:
            before = span_card_ms(pipe)
        finally:
            parcels.most_unstable_kernel = kernel
        span_rows[label] = {'before': before, 'after': after}
        names = sorted(k for k in set(before) | set(after)
                       if k.startswith('xparcel.prep.'))
        log(f'[4 spans {label}] card ms of one conv_properties_fused call '
            f'by the innermost span that launched each kernel, twin -> '
            f'kernel: ' + ', '.join(
                f'{k[13:]} {before.get(k, 0.0):.3f} -> {after.get(k, 0.0):.3f}'
                for k in names) + '; all preps '
            f'{sum(before.get(k, 0.0) for k in names):.3f} -> '
            f'{sum(after.get(k, 0.0) for k in names):.3f}; the call '
            f'{sum(before.values()):.3f} -> {sum(after.values()):.3f} '
            f'({smi})')
        del dat, uargs, up, ut
    targs = tuple(x.contiguous() for x in (p, t, td, h))
    tplain_a, want = cuda_ms(lambda: diag._diag_body(*targs), 3)
    tkern_a, got = cuda_ms(lambda: diag.diag_kernel(*targs), 10)
    tkern_b, _ = cuda_ms(lambda: diag.diag_kernel(*targs), 10)
    tplain_b, _ = cuda_ms(lambda: diag._diag_body(*targs), 3)
    tail_ms, tail_plain_ms = (tkern_a + tkern_b) / 2, (tplain_a + tplain_b) / 2
    full_err = compare('tail/main shape/', dict(zip(diag.DIAG_OUTPUTS, got)),
                       dict(zip(diag.DIAG_OUTPUTS, want)), 'float32')
    tail_bound = bound(*tail_work(*targs), torch.float32)
    log(f'[4 timing] tail {MAIN_COLUMNS} x {LEVELS} float32: kernel '
        f'{tkern_a:.3f}/{tkern_b:.3f} ms, plain twin {tplain_a:.3f}/'
        f'{tplain_b:.3f} ms, bound {tail_bound[0]:.3f} ms by '
        f'{tail_bound[1]} ({smi}); kernel vs twin there within the '
        f'float32 budget, max |diff| {full_err:.3g}')
    del got, want, targs

    # 5. The main path, float32, full size: every entry point, each driven
    # with the launch counts set to 0 just before it and read just after.
    dat = {k: torch.as_tensor(v, device=dev) for k, v in dat_np.items()}
    paths = {
        'surface': (lambda: xt.fused_surface_cape_cin(
            p, t, td, tables=tab32, with_lifted_index=True), (1, 0)),
        'pipeline': (lambda: xt.conv_properties_fused(dat, tables=tab32),
                     (3, 1)),
        'reduced': (lambda: xt.min_conv_properties_fused(dat, tables=tab32),
                    (1, 1)),
    }
    outs, launches = {}, {'fused_cape_cin': 0, 'diag_tail': 0,
                          'mix_layers': 0, 'most_unstable': 0}
    for name, (run, want_counts) in paths.items():
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        fused.prepass_kernel.launches = 0
        parcels.bridge_neighbors_kernel.launches = 0
        parcels.mix_layers_kernel.launches = 0
        parcels.most_unstable_kernel.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if counts != want_counts:
            raise AssertionError(f'{name}: (solve, tail) launches {counts}, '
                                 f'want {want_counts}')
        if fused.prepass_kernel.launches != counts[0]:
            raise AssertionError(f'{name}: {fused.prepass_kernel.launches} '
                                 f'pre-pass launches for {counts[0]} solves')
        # One mixed-layer launch a fused pipeline call, none for the
        # surface; the neighbours kernel is on neither.
        if (parcels.mix_layers_kernel.launches,
                parcels.bridge_neighbors_kernel.launches) != (
                    name != 'surface', 0):
            raise AssertionError(
                f'{name}: {parcels.mix_layers_kernel.launches} mixed-layer '
                f'and {parcels.bridge_neighbors_kernel.launches} neighbours '
                f'launches')
        launches['fused_cape_cin'] += counts[0]
        launches['diag_tail'] += counts[1]
        # One most-unstable launch a full fused pipeline call, none for
        # the reduced one or the surface.
        if parcels.most_unstable_kernel.launches != (name == 'pipeline'):
            raise AssertionError(
                f'{name}: {parcels.most_unstable_kernel.launches} '
                f'most-unstable launches')
        launches['mix_layers'] += parcels.mix_layers_kernel.launches
        launches['most_unstable'] += parcels.most_unstable_kernel.launches
        outs[name] = {**out[0], **out[1]} if name == 'surface' else out
    outs['proxies'] = xt.storm_proxies(outs['pipeline'])
    for name, out in outs.items():
        for k, v in out.items():
            if v.shape != (MAIN_COLUMNS,) or v.device != p.device or (
                    v.dtype not in (torch.float32, torch.bool)):
                raise AssertionError(f'{name}/{k}: {v.dtype} {v.shape} '
                                     f'on {v.device}')

    # The subsample through the plain path on the CPU.
    sub = torch.arange(0, MAIN_COLUMNS, MAIN_COLUMNS // CHECK_COLUMNS)
    tab_cpu = xt.AdiabatTables(tab32.coeffs.cpu())
    dat_cpu = {k: v[sub].cpu() for k, v in dat.items()}
    ref_res, ref_sol = xt.fused_surface_cape_cin(
        p[sub].cpu(), t[sub].cpu(), td[sub].cpu(), tables=tab_cpu,
        with_lifted_index=True)
    refs = {
        'surface': {**ref_res, **ref_sol},
        'pipeline': xt.conv_properties_fused(dat_cpu, tables=tab_cpu),
        'reduced': xt.min_conv_properties_fused(dat_cpu, tables=tab_cpu),
    }
    refs['proxies'] = xt.storm_proxies(refs['pipeline'])
    for name, ref in refs.items():
        out = outs[name]
        if set(out) != set(ref):
            raise AssertionError(f'{name}: outputs {sorted(out)} vs '
                                 f'{sorted(ref)}')
        for k in ref:
            o = out[k][sub].cpu()
            if ref[k].dtype != torch.bool:
                lost = torch.isfinite(ref[k]) & ~torch.isfinite(o)
                if lost.any():
                    raise AssertionError(f'{name}/{k}: {int(lost.sum())} '
                                         f'values not finite where the '
                                         f'plain path is')
        compare(f'{name}/', {k: out[k][sub] for k in ref}, ref, 'float32')
    pipe = outs['pipeline']
    n_cape = int(torch.isfinite(pipe['mu_cape']).sum())
    log(f'[5 main path] surface, pipeline, reduced pipeline and storm '
        f'proxies at {MAIN_COLUMNS} x {LEVELS} float32: (solve, tail) '
        f'launches 1+0, 3+1, 1+1; mixed-layer 0, 1, 1 and most-unstable '
        f'0, 1, 0 launches; '
        f'{CHECK_COLUMNS} columns within the float32 budget of the CPU '
        f'plain path; mu_cape finite in {n_cape} columns, mean '
        f'{pipe["mu_cape"].nanmean().item():.2f} J/kg')

    rates = {name: MAIN_COLUMNS / wall_median(run, 5)
             for name, (run, _) in paths.items()}
    log('[5 rate] ' + ', '.join(
        f'{name} {rate:.4g} columns/s ({MAIN_COLUMNS / rate * 1e3:.2f} ms)'
        for name, rate in rates.items()) + f', float32, {smi}')

    # 6. The modular path on the card: plain torch, no kernel launched but
    # the neighbours (mixed_layer's bridge_neighbors) and, in the full
    # pipeline, the most-unstable prep.
    modular = {
        'modular': (lambda: xt.conv_properties(dat, tables=tab32),
                    'pipeline', xt.conv_properties),
        'modular reduced': (lambda: xt.min_conv_properties(dat, tables=tab32),
                            'reduced', xt.min_conv_properties),
    }
    mod_rates, peaks = {}, {}
    for name, (run, fused_name, fn) in modular.items():
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated(), base)
        counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if counts != (0, 0):
            raise AssertionError(f'{name}: (solve, tail) launches {counts}, '
                                 f'want (0, 0)')
        if set(out) != set(outs[fused_name]):
            raise AssertionError(f'{name}: outputs {sorted(out)}')
        for k, v in out.items():
            if v.shape != (MAIN_COLUMNS,) or v.device != p.device:
                raise AssertionError(f'{name}/{k}: {v.shape} on {v.device}')
        # Every column against the fused pipeline on the card, and the
        # subsample against the modular path on the CPU.
        compare(f'{name} vs fused/', out, outs[fused_name], 'float32')
        ref = fn(dat_cpu, tables=tab_cpu)
        compare(f'{name} vs CPU/', {k: out[k][sub] for k in ref}, ref,
                'float32')
        del out
        mod_rates[name] = MAIN_COLUMNS / wall_median(run, 5)
    log('[6 modular] ' + '; '.join(
        f'{name}: (solve, tail) launches 0+0, all {MAIN_COLUMNS} columns '
        f'within the float32 budget of the fused pipeline, {CHECK_COLUMNS} '
        f'of the CPU modular path; {mod_rates[name]:.4g} columns/s '
        f'({MAIN_COLUMNS / mod_rates[name] * 1e3:.2f} ms); peak '
        f'{peaks[name][0] / 2**30:.2f} GiB allocated '
        f'({peaks[name][1] / 2**30:.2f} GiB before the call)'
        for name in modular) + f'; float32, {smi}')

    # 7. Gradients on the card, through the kernels' autograd.Functions.
    grad_err = {}
    keys = ('cape', 'cin', 'lifted_index')

    def solve_grads(cols, parcel, tab):
        leaves = [x.detach().clone().requires_grad_()
                  for x in (*cols.values(), *parcel.values())]
        res, _ = xt.fused_cape_cin(
            *leaves[:3], parcel_pressure=leaves[3],
            parcel_temperature=leaves[4], parcel_dewpoint=leaves[5],
            tables=tab, with_lifted_index=True)
        return torch.autograd.grad(finite_sum(res, keys), leaves)

    hard64 = [torch.as_tensor(x, device=dev) for x in (p_np, t_np, td_np)]
    cols, parcel = variant_columns(*hard64)
    fused.cape_cin_kernel.launches = 0
    g_card = solve_grads(cols, parcel, tab64)
    n = fused.cape_cin_kernel.launches
    if n != 1:
        raise AssertionError(f'gradient solve: {n} kernel launches, want 1')
    tab64_cpu = xt.AdiabatTables(tab64.coeffs.cpu())
    g_cpu = solve_grads({k: v.cpu() for k, v in cols.items()},
                        {k: v.cpu() for k, v in parcel.items()}, tab64_cpu)
    repeated = repeated_level(cols['pressure'])
    grad_err['solve'] = compare_grads('solve gradient', g_card, g_cpu,
                                      skip=repeated)

    # The golden sounding's d(CAPE)/d(surface T) against central
    # differences of the kernel's forward.
    gp = torch.tensor([[959., 779.2, 751.3, 724.3, 700., 269.]],
                      dtype=torch.float64, device=dev)
    gt = torch.tensor([[22.2, 14.6, 12., 9.4, 7., -38.]],
                      dtype=torch.float64, device=dev) + 273.15
    gd = torch.tensor([[19., -11.2, -10.8, -10.4, -10., -53.2]],
                      dtype=torch.float64, device=dev) + 273.15

    def golden_cape(t0):
        tt = torch.cat([t0.reshape(1, 1), gt[:, 1:]], -1)
        return xt.fused_surface_cape_cin(gp, tt, gd, tables=tab64)[0][
            'cape'][0]

    t0 = gt[0, 0].clone().requires_grad_()
    g_gold = torch.autograd.grad(golden_cape(t0), t0)[0].item()
    with torch.no_grad():
        fd = ((golden_cape(gt[0, 0] + 1e-4) - golden_cape(gt[0, 0] - 1e-4))
              / 2e-4).item()
    if not abs(g_gold - fd) <= 1e-4 * abs(fd):
        raise AssertionError(f'golden gradient {g_gold!r} vs central '
                             f'difference {fd!r}')

    # The full fused pipeline's gradient (both Functions) on the
    # subsample, float64, against the CPU's.
    def pipeline_grads(d, tab):
        d = dict(d)
        leaves = [d[k].detach().clone().requires_grad_()
                  for k in ('temperature', 'specific_humidity')]
        d['temperature'], d['specific_humidity'] = leaves
        out = xt.conv_properties_fused(d, tables=tab)
        floats = [k for k in sorted(out) if out[k].dtype != torch.bool]
        return torch.autograd.grad(finite_sum(out, floats), leaves)

    dat64 = {k: v[sub].double() for k, v in dat.items()}
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    g_card = pipeline_grads(dat64, tab64)
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (3, 1):
        raise AssertionError(f'pipeline gradient: launches {counts}')
    g_cpu = pipeline_grads({k: v.cpu() for k, v in dat64.items()},
                           tab64_cpu)
    grad_err['pipeline'] = compare_grads('pipeline gradient', g_card, g_cpu)

    # Forward plus backward of the surface solve, float32.
    n_grad = 65_536
    gcols = [x[:n_grad] for x in (p, t, td)]

    def surface_step(backward=True):
        tt = gcols[1].detach().clone().requires_grad_(backward)
        res, _ = xt.fused_surface_cape_cin(gcols[0], tt, gcols[2],
                                           tables=tab32,
                                           with_lifted_index=True)
        if backward:
            torch.autograd.grad(finite_sum(res, keys), tt)

    fwd_bwd_s = wall_median(surface_step, 5)
    fwd_s = wall_median(lambda: surface_step(False), 5)
    log(f'[7 gradients] float64 through the solve Function on '
        f'{cols["pressure"].shape[0]} hard columns (1 launch) vs the CPU '
        f'twin: identical NaN patterns; max diff {grad_err["solve"]:.3g} '
        f'of scale outside the {int(repeated.sum())} columns with a '
        f'repeated level (not differentiable there); golden '
        f'd(CAPE)/dT0 {g_gold:.6f} vs central difference {fd:.6f}; '
        f'conv_properties_fused gradient (3+1 launches) on {CHECK_COLUMNS} '
        f'columns vs the CPU: {grad_err["pipeline"]:.3g} of scale; '
        f'fused_surface_cape_cin at {n_grad} float32 columns forward plus '
        f'backward {fwd_bwd_s * 1e3:.2f} ms (forward alone '
        f'{fwd_s * 1e3:.2f} ms), {smi}')

    # 8. The solve's options: kernel against twin for each setting.
    opt_err = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split('.')[-1]
        tab = tab64 if dtype == torch.float64 else tab32
        sets = {LEVELS: kernel_args(*(torch.as_tensor(x, dtype=dtype,
                                                      device=dev)
                                      for x in (p_np, t_np, td_np)), tab)}
        for L in EDGE_LEVELS:
            sets[L] = lane_edge_args(EDGE_COLUMNS, tab, L=L)
        worst = 0.0
        for L, args in sets.items():
            for kw in SOLVE_OPTIONS:
                tag = f'options/{dname}/L={L}/{kw or "default"}/'
                got = fused.cape_cin_kernel(*args, **kw)
                got_p, prof = fused.cape_cin_kernel(*args, with_profile=True,
                                                    **kw)
                torch.cuda.synchronize()
                want, want_prof = fused._column_outputs(
                    *args, with_profile=True, **kw)
                if not torch.equal(got.nan_to_num(7.0),
                                   got_p.nan_to_num(7.0)):
                    raise AssertionError(f'{tag}: outputs differ with and '
                                         f'without the profile tracks')
                worst = max(worst,
                            compare(tag, dict(zip(fused.OUTPUTS, got)),
                                    dict(zip(fused.OUTPUTS, want)), dname),
                            compare(tag + 'profile/',
                                    dict(zip(fused.PROFILE, prof)),
                                    dict(zip(fused.PROFILE, want_prof)),
                                    dname))
        opt_err[dname] = worst
    log(f'[8 options] {len(SOLVE_OPTIONS)} settings (each option alone and '
        f'all four) x with and without the profile tracks, on '
        f'{4 * HARD_COLUMNS} hard columns x {LEVELS} and {4 * EDGE_COLUMNS} '
        f'lane-edge columns at {EDGE_LEVELS[0]} and {EDGE_LEVELS[1]} levels '
        f'vs the plain twin: float64 identical NaN patterns, max |diff| '
        f'{opt_err["float64"]:.3g}; float32 within the budget, max |diff| '
        f'{opt_err["float32"]:.3g}; at {MAIN_COLUMNS} x {LEVELS} float32 the '
        f'default instance {kern_a:.3f}/{kern_b:.3f} ms, the instance that '
        f'reads the flags word {flags_ms:.3f} ms (all four options), {smi}')

    # 9. The tables, built and cached by the entry point a user calls.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = xt.load_moist_adiabat_lookups(regenerate=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if (loaded.coeffs.device.type != 'cuda'
            or loaded.coeffs.dtype != torch.float32
            or loaded.curves is None or loaded.lookup is None):
        raise AssertionError('loaded tables: not float32 on the card with '
                             'curves and lookup')
    if adiabat.default_tables(dev, torch.float32) is not loaded:
        raise AssertionError('default_tables does not return what was loaded')
    coeff_err = (loaded.coeffs - tab32.coeffs).abs().max().item()
    if coeff_err != 0.0:
        raise AssertionError(f'loaded coefficients off build_spectral by '
                             f'{coeff_err:.3g}')
    t0 = time.perf_counter()
    again = xt.AdiabatTables.load(adiabat._LOADED_SOURCE, dev)
    reload_s = time.perf_counter() - t0
    for name in ('coeffs', 'curves', 'lookup'):
        if not torch.equal(getattr(again, name).nan_to_num(-1.0),
                           getattr(loaded, name).nan_to_num(-1.0)):
            raise AssertionError(f'tables: {name} changed in a save and load')
    del again
    rng = np.random.default_rng(5)
    lift_p = torch.as_tensor(
        np.linspace(1000.0, 150.0, LEVELS) + rng.normal(0, 0.3, (4096, LEVELS)),
        dtype=torch.float32, device=dev)
    lift_t = torch.as_tensor(rng.uniform(255.0, 305.0, 4096),
                             dtype=torch.float32, device=dev)
    exact = adiabat.moist_lapse_integrate(lift_p.double(), lift_t.double(),
                                          lift_p[:, 0].double())
    mode_err = {}
    for mode, kw in (('bilinear index', dict(index_mode='bilinear')),
                     ('nearest index', dict(index_mode='nearest')),
                     ('curves, no blend', dict(curve_blend=False)),
                     ('curves, bilinear index, no blend',
                      dict(index_mode='bilinear', curve_blend=False))):
        got = adiabat.moist_lapse(lift_p, lift_t, lift_p[:, 0],
                                  tables=loaded, **kw)
        err = (got.double() - exact).abs()
        atol = TABLE_ATOL['nearest' if 'nearest' in mode else 'bilinear']
        if not torch.isfinite(err).all() or err.max().item() > atol:
            raise AssertionError(f'moist_lapse {mode}: max |diff| '
                                 f'{err.max().item():.3g} K vs the integrator')
        mode_err[mode] = err.max().item()
    log(f'[9 tables] load_moist_adiabat_lookups(regenerate=True) built '
        f'coeffs, curves {tuple(loaded.curves.shape)} and lookup '
        f'{tuple(loaded.lookup.shape)} on the card and cached them in '
        f'{load_s:.2f} s (read back from the file in {reload_s:.2f} s, '
        f'unchanged); coeffs equal build_spectral\'s; moist_lapse on them '
        f'vs moist_lapse_integrate on 4096 x {LEVELS}: ' + ', '.join(
            f'{m} {e:.3g} K' for m, e in mode_err.items()) + f'; {smi}')

    # 10. A Dataset on the host through the surfaces a user calls, with the
    # default device.  The reference is the tensor-level path on the same
    # columns, contiguous as the lowering makes them (the synthetic
    # pressure of phase 5 is column-major, and a reduction over a strided
    # level axis may sum in another order): the same computation.
    ds = grid_dataset(dat_np, td_main, GRID)
    dat_c = {k: v.contiguous() for k, v in dat.items()}
    res, sol = xt.fused_surface_cape_cin(
        dat_c['pressure'], t, td, tables=tab32, with_lifted_index=True)
    refs = {'pipeline': xt.conv_properties_fused(dat_c, tables=tab32),
            'reduced': xt.min_conv_properties_fused(dat_c, tables=tab32),
            'surface': {**res, **sol}}
    refs['proxies'] = xt.storm_proxies(refs['pipeline'])
    ds_paths = {
        'pipeline': (lambda d: xapi.conv_properties_fused(d), (3, 1)),
        'reduced': (lambda d: xapi.min_conv_properties_fused(d), (1, 1)),
        'surface': (lambda d: xapi.surface_based_cape_cin_dataset(
            d, with_lifted_index=True), (1, 0)),
    }
    ds_outs = {}
    for name, (run, want_counts) in ds_paths.items():
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        ds_outs[name] = run(ds)
        counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if counts != want_counts:
            raise AssertionError(f'Dataset {name}: (solve, tail) launches '
                                 f'{counts}, want {want_counts}')
        launches['fused_cape_cin'] += counts[0]
        launches['diag_tail'] += counts[1]
        same_as_tensors(f'Dataset {name}', ds_outs[name], refs[name])
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    ds_outs['proxies'] = xapi.storm_proxies(ds_outs['pipeline'])
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (0, 0):
        raise AssertionError(f'Dataset proxies: launches {counts}')
    same_as_tensors('Dataset proxies', ds_outs['proxies'], refs['proxies'])

    # Mixed dims: pressure as a 1-D coordinate variable, a smaller grid.
    n_small = SMALL_GRID[0] * SMALL_GRID[1]
    small = grid_dataset(dat_np, td_main, SMALL_GRID, pressure_1d=True)
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    small_out = xapi.conv_properties_fused(small)
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (3, 1):
        raise AssertionError(f'mixed-dims Dataset: launches {counts}')
    launches['fused_cape_cin'] += counts[0]
    launches['diag_tail'] += counts[1]
    same_as_tensors('mixed-dims Dataset', small_out,
                    xt.conv_properties_fused(
                        {k: v[:n_small] for k, v in dat_c.items()},
                        tables=tab32))
    del refs, dat_c

    # End to end, and the same steps one by one.
    whole_s = wall_median(lambda: xapi.conv_properties_fused(ds), 3)
    use = [k for k in ds.data_vars if k != 'dewpoint']
    split = {}

    def timed(step, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[step] = time.perf_counter() - t0
        return out

    fields, batch_dims = timed('lowering', lambda: xapi.from_dataset(
        ds, variables=use))
    on_card = timed('host to device', lambda: xapi.to_device(fields, dev))
    cols = {k: v.reshape((MAIN_COLUMNS,) + tuple(v.shape[2:]))
            for k, v in on_card.items()}
    out_card = timed('compute', lambda: xt.conv_properties_fused(cols))
    out_host = timed('device to host', lambda: xapi.to_host(out_card))
    timed('lifting', lambda: xapi.to_dataset(
        {k: v.reshape(GRID) for k, v in out_host.items()}, batch_dims,
        coords={d: ds.coords[d] for d in batch_dims}))
    in_bytes = sum(v.nbytes for v in fields.values())
    out_bytes = sum(v.nbytes for v in out_host.values())
    del fields, on_card, cols, out_card, out_host
    log(f'[10 dataset] {GRID[0]} x {GRID[1]} x {LEVELS} float32 Dataset, '
        f'level dim leading, default device: conv_properties_fused, '
        f'min_conv_properties_fused, surface_based_cape_cin_dataset and '
        f'storm_proxies with (solve, tail) launches 3+1, 1+1, 1+0, 0+0, and '
        f'conv_properties_fused on a {SMALL_GRID[0]} x {SMALL_GRID[1]} grid '
        f'with a 1-D pressure coordinate (3+1): every variable bit-equal to '
        f'the tensor-level path, attrs and coordinates on each; '
        f'conv_properties_fused host Dataset to host Dataset '
        f'{whole_s * 1e3:.1f} ms, {MAIN_COLUMNS / whole_s:.4g} columns/s; '
        f'its steps alone: ' + ', '.join(
            f'{k} {v * 1e3:.1f} ms' for k, v in split.items()) +
        f' ({in_bytes / 1e6:.0f} MB in, {out_bytes / 1e6:.0f} MB out); {smi}')

    # 11. The same Dataset streamed in column chunks.
    def peak_of(run):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    _, whole_peak = peak_of(lambda: xapi.conv_properties_fused(ds))
    n_chunks = -(-MAIN_COLUMNS // STREAM_COLUMNS)
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    streamed, stream_peak = peak_of(lambda: xapi.conv_properties_fused(
        ds, stream_columns=STREAM_COLUMNS))
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (3 * n_chunks, n_chunks):
        raise AssertionError(f'streamed Dataset: launches {counts} in '
                             f'{n_chunks} chunks')
    launches['fused_cape_cin'] += counts[0]
    launches['diag_tail'] += counts[1]
    whole = ds_outs['pipeline']
    if set(streamed.data_vars) != set(whole.data_vars):
        raise AssertionError('streamed Dataset: other variables')
    stream_err = compare(
        'streamed vs whole/',
        {k: torch.from_numpy(np.asarray(streamed[k].values))
         for k in whole.data_vars},
        {k: torch.from_numpy(np.asarray(whole[k].values))
         for k in whole.data_vars}, 'float32')
    unequal = [k for k in whole.data_vars if not np.array_equal(
        np.asarray(streamed[k].values), np.asarray(whole[k].values),
        equal_nan=np.asarray(whole[k].values).dtype.kind == 'f')]
    if not all(streamed[k].attrs for k in streamed.data_vars):
        raise AssertionError('streamed Dataset: a variable has no attrs')
    stream_s = wall_median(lambda: xapi.conv_properties_fused(
        ds, stream_columns=STREAM_COLUMNS), 3)
    log(f'[11 streamed] the same Dataset with stream_columns='
        f'{STREAM_COLUMNS}: {n_chunks} chunks, (solve, tail) launches '
        f'{counts[0]}+{counts[1]}; vs the whole call within the float32 '
        f'budget, max |diff| {stream_err:.3g}, '
        f'{len(unequal)} of {len(whole.data_vars)} variables not bit-equal'
        f'{" (" + ", ".join(unequal) + ")" if unequal else ""}; '
        f'{stream_s * 1e3:.1f} ms, {MAIN_COLUMNS / stream_s:.4g} columns/s '
        f'(whole {whole_s * 1e3:.1f} ms); peak device memory above what was '
        f'allocated before the call {stream_peak / 2**30:.2f} GiB streamed, '
        f'{whole_peak / 2**30:.2f} GiB whole; {smi}')

    # 12. A mesh: two entries on the one card, an uneven batch.
    mesh = parallel.make_mesh([dev, dev])
    n_uneven = MAIN_COLUMNS - 1
    dat_c = {k: v.contiguous() for k, v in dat.items()}
    single = xt.conv_properties_fused(
        {k: v[:n_uneven] for k, v in dat_c.items()}, tables=tab32)
    padded, lead = parallel.pad_batch(
        {k: v[:n_uneven] for k, v in dat_np.items()}, mesh)
    if lead != n_uneven or any(v.shape[0] != MAIN_COLUMNS
                               for v in padded.values()):
        raise AssertionError('pad_batch: wrong sizes')
    copies = parallel.replicate(tab32, mesh)
    run_sharded = parallel.sharded_map(
        lambda d, tables: xt.conv_properties_fused(d, tables=tables), mesh)
    sharded_in = parallel.shard_batch(padded, mesh)
    del padded
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    sharded = run_sharded(sharded_in, tables=copies)
    torch.cuda.synchronize()
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (6, 2):
        raise AssertionError(f'sharded pipeline: (solve, tail) launches '
                             f'{counts}, want (6, 2)')
    launches['fused_cape_cin'] += counts[0]
    launches['diag_tail'] += counts[1]
    if set(sharded) != set(single):
        raise AssertionError('sharded pipeline: other variables')
    for k, v in single.items():
        got = sharded[k]
        if (got.shape != (MAIN_COLUMNS,) or len(got.shards) != 2
                or got.devices != {dev}):
            raise AssertionError(f'sharded {k}: {got}')
        want = v.cpu().numpy()
        if not np.array_equal(got.numpy()[:lead], want,
                              equal_nan=want.dtype.kind == 'f'):
            raise AssertionError(f'sharded {k}: not bit-equal to the single '
                                 f'call')
    sharded_s = wall_median(lambda: run_sharded(sharded_in, tables=copies), 5)
    del sharded_in, single

    # The Dataset surface with the mesh, whole and streamed.
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    ds_mesh = xapi.conv_properties_fused(ds, mesh=mesh)
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (6, 2):
        raise AssertionError(f'Dataset mesh=: launches {counts}')
    launches['fused_cape_cin'] += counts[0]
    launches['diag_tail'] += counts[1]
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    ds_mesh_streamed = xapi.conv_properties_fused(
        ds, stream_columns=STREAM_COLUMNS, mesh=mesh)
    counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
    if counts != (6 * n_chunks, 2 * n_chunks):
        raise AssertionError(f'Dataset mesh= streamed: launches {counts} in '
                             f'{n_chunks} chunks of 2 shards')
    launches['fused_cape_cin'] += counts[0]
    launches['diag_tail'] += counts[1]

    def same_datasets(name, got, want):
        """Every variable bit-equal, with its attrs; the same coords."""
        if set(got.data_vars) != set(want.data_vars):
            raise AssertionError(f'{name}: other variables')
        for k in want.data_vars:
            a, b = np.asarray(got[k].values), np.asarray(want[k].values)
            if a.dtype != b.dtype or not np.array_equal(
                    a, b, equal_nan=b.dtype.kind == 'f'):
                raise AssertionError(f'{name}/{k}: not bit-equal')
            if got[k].attrs != want[k].attrs or got[k].dims != want[k].dims:
                raise AssertionError(f'{name}/{k}: attrs or dims differ')
        for c in want.coords:
            if not np.array_equal(np.asarray(got.coords[c].values),
                                  np.asarray(want.coords[c].values)):
                raise AssertionError(f'{name}: coordinate {c} differs')

    same_datasets('Dataset mesh=', ds_mesh, whole)
    same_datasets('Dataset mesh= streamed', ds_mesh_streamed, streamed)
    ds_mesh_s = wall_median(lambda: xapi.conv_properties_fused(ds, mesh=mesh),
                            3)
    del ds_mesh, ds_mesh_streamed

    # The validation reduction through a one-process NCCL group: a real
    # all-reduce on the card.
    if not dist.is_nccl_available():
        raise AssertionError('torch.distributed has no NCCL')
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    parallel.distributed_init(f'127.0.0.1:{port}', 1, 0)
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, want nccl')
        cnt, mean, mx = parallel.global_stats(sharded['mu_cape'], mesh)
    finally:
        dist.destroy_process_group()
    mu = sharded['mu_cape'].numpy()
    fin = np.isfinite(mu)
    if (int(cnt) != int(fin.sum()) or float(mx) != float(mu[fin].max())
            or abs(float(mean) - mu[fin].astype(np.float64).mean())
            > 1e-9 * abs(float(mean))):
        raise AssertionError(f'global_stats {int(cnt)}, {float(mean)!r}, '
                             f'{float(mx)!r} vs numpy {int(fin.sum())}, '
                             f'{mu[fin].astype(np.float64).mean()!r}, '
                             f'{mu[fin].max()!r}')
    del sharded
    log(f'[12 mesh] 2-way mesh on the one card (cuda:0 twice, one host '
        f'thread per entry), {n_uneven} columns padded to {MAIN_COLUMNS}: '
        f'conv_properties_fused through sharded_map bit-equal to the single '
        f'call on every variable, (solve, tail) launches 6+2; '
        f'{MAIN_COLUMNS / sharded_s:.4g} columns/s ({sharded_s * 1e3:.2f} '
        f'ms) against the single call\'s {rates["pipeline"]:.4g} (one card: '
        f'this is what the machinery costs, not a speed-up; several cards '
        f'were not measured); xarray_api.conv_properties_fused(ds, mesh=) '
        f'bit-equal to the unsharded call, {ds_mesh_s * 1e3:.1f} ms (whole '
        f'{whole_s * 1e3:.1f} ms), and with stream_columns={STREAM_COLUMNS} '
        f'({6 * n_chunks}+{2 * n_chunks} launches) bit-equal to the '
        f'unsharded streamed call; global_stats of mu_cape through a '
        f'one-process NCCL all-reduce equals numpy: {int(cnt)} finite, mean '
        f'{float(mean):.3f}, max {float(mx):.3f}; {smi}')

    # 13. Deployment: export, serve in a fresh process, serve in process.
    want13 = xt.conv_properties_fused(dat_c, tables=tab32)
    want13.update(xt.storm_proxies(want13))
    root = os.path.dirname(os.path.abspath(__file__))
    lib_path = _build.library_path()

    def bit_equal(name, got):
        """Hold host arrays ``got`` to ``want13`` bit for bit."""
        for k, v in want13.items():
            ref = v[:len(got[k])].cpu().numpy()
            differ = ~((got[k] == ref) | (np.isnan(got[k].astype(float))
                                          & np.isnan(ref.astype(float))))
            if not isinstance(got[k], np.ndarray) or differ.any():
                raise AssertionError(
                    f'{name}/{k}: {int(differ.sum())} columns not bit-equal '
                    f'to the in-process pipeline, first {differ.argmax()}: '
                    f'{got[k][differ][:4]} vs {ref[differ][:4]}')

    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, 'pipeline.xpz')
        dep = deploy.export_pipeline(
            'conv_properties_fused_with_proxies', batch=STREAM_COLUMNS,
            levels=LEVELS, tables=tab32, path=art)
        if not dep.meta['slim'] or not dep.meta['kernel_library']:
            raise AssertionError(f'artifact: {dep.meta}')
        art_bytes = os.path.getsize(art)
        infile = os.path.join(tmp, 'in.npz')
        outfile = os.path.join(tmp, 'out.npz')
        # Host arrays as a file gives them: each its own contiguous block
        # (the synthetic pressure is a broadcast view, slow to copy from).
        dat_host = {k: np.ascontiguousarray(v) for k, v in dat_np.items()}
        np.savez(infile, **dat_host)
        no_cache = os.path.join(tmp, 'no_tables.npz')
        env = dict(os.environ, XPARCEL_TORCH_TABLE_CACHE=no_cache)
        env['PATH'] = os.pathsep.join(
            d for d in env.get('PATH', '').split(os.pathsep)
            if not os.path.exists(os.path.join(d, 'nvcc')))
        aside = lib_path + '.aside'
        os.replace(lib_path, aside)
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, '-m', 'xarray_parcel_tpu_torch.deploy',
                 'serve', art, '--input', infile, '-o', outfile],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=600)
            fresh_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f'fresh serving process failed:\n'
                                     f'{proc.stdout}\n{proc.stderr[-3000:]}')
            with open(lib_path, 'rb') as f:
                if f.read() != dep._library:
                    raise AssertionError('the serving process did not take '
                                         'the artifact\'s kernel library')
        finally:
            os.replace(aside, lib_path)
        if os.path.exists(no_cache):
            raise AssertionError('the serving process built tables')
        with np.load(outfile) as f:
            served = {k: f[k] for k in f.files}
        if set(served) != set(want13):
            raise AssertionError('served: other variables')
        serve_err = compare('served vs pipeline/',
                            {k: torch.from_numpy(v)
                             for k, v in served.items()}, want13, 'float32')

        # The same artifact loaded here: an exact fit on device tensors,
        # and host arrays streamed in chunks of the exported batch.
        loaded = deploy.load(art)
        fit = {k: v[:STREAM_COLUMNS] for k, v in dat_c.items()}
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        out_fit = loaded(fit)
        counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if counts != (3, 1):
            raise AssertionError(f'Deployed exact fit: launches {counts}')
        launches['fused_cape_cin'] += counts[0]
        launches['diag_tail'] += counts[1]
        if any(v.device != dev for v in out_fit.values()):
            raise AssertionError('Deployed exact fit: outputs off the card')
        bit_equal('Deployed exact fit', xapi.to_host(out_fit))
        fit_rate, _ = utils.columns_per_second(loaded, fit,
                                               columns=STREAM_COLUMNS)
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        out_host = loaded(dat_host)
        counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if counts != (3 * n_chunks, n_chunks):
            raise AssertionError(f'Deployed streamed: launches {counts}')
        launches['fused_cape_cin'] += counts[0]
        launches['diag_tail'] += counts[1]
        bit_equal('Deployed streamed', out_host)
        bit_equal('fresh serving process', served)
        n_served = len(served)
        del served
        del out_host, out_fit
        host_s = wall_median(lambda: loaded(dat_host), 3)
        del dat_host

        # A Dataset through the artifact.
        fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
        ds_served = xapi.serve(ds, loaded)
        counts = (fused.cape_cin_kernel.launches, diag.diag_kernel.launches)
        if counts != (3 * n_chunks, n_chunks):
            raise AssertionError(f'xarray_api.serve: launches {counts}')
        launches['fused_cape_cin'] += counts[0]
        launches['diag_tail'] += counts[1]
        same_datasets('xarray_api.serve', ds_served, xapi.xr.merge(
            [whole, ds_outs['proxies']]))
        del ds_served
    del want13
    log(f'[13 deploy] conv_properties_fused_with_proxies exported slim at '
        f'batch {STREAM_COLUMNS}: {art_bytes} bytes with the kernel library; '
        f'`python -m xarray_parcel_tpu_torch.deploy serve` of {MAIN_COLUMNS} '
        f'columns from an .npz in a fresh process, with the kernel library '
        f'moved aside, no nvcc on PATH and an empty table cache: '
        f'{fresh_s:.2f} s from start to outputs written (it took the '
        f'artifact\'s library and built no tables; this run built the '
        f'library in {build_s:.2f} s, the coefficients in {tables_s:.2f} s '
        f'and the cached tables in {load_s:.2f} s), all '
        f'{n_served} variables bit-equal to the in-process '
        f'pipeline, max |diff| {serve_err:.3g}; Deployed in this process: '
        f'exact fit on device tensors (3+1 launches, device tensors out) '
        f'{fit_rate:.4g} columns/s, {MAIN_COLUMNS} columns of host arrays '
        f'streamed in chunks ({3 * n_chunks}+{n_chunks} launches) '
        f'{MAIN_COLUMNS / host_s:.4g} columns/s ({host_s * 1e3:.1f} ms), both '
        f'bit-equal; xarray_api.serve of the Dataset: every variable, attrs '
        f'and coords equal to conv_properties_fused and storm_proxies; '
        f'{smi}')
    del dat_c

    # 14. The C++ ingest and the timers.
    if not native.available():
        raise AssertionError('native.available() is false: the C++ ingest '
                             'did not build')
    var = np.asarray(ds['temperature'].values)

    def host_ms(fn):
        return wall_median(fn, 5) * 1e3

    moved = native.levels_to_last(var)
    if not np.array_equal(moved, native._levels_to_last_numpy(var)) or (
            moved.shape != GRID + (LEVELS,)):
        raise AssertionError('levels_to_last: C++ and numpy differ')
    del moved
    numpy_a = host_ms(lambda: native._levels_to_last_numpy(var))
    cxx_a = host_ms(lambda: native.levels_to_last(var))
    cxx_b = host_ms(lambda: native.levels_to_last(var))
    numpy_b = host_ms(lambda: native._levels_to_last_numpy(var))
    cps, cps_s = utils.columns_per_second(
        lambda *a: xt.fused_surface_cape_cin(*a, tables=tab32,
                                             with_lifted_index=True),
        p, t, td)
    if utils.infer_columns((p,)) != MAIN_COLUMNS:
        raise AssertionError('infer_columns: wrong count')
    if not 0.5 <= cps / rates['surface'] <= 2.0:
        raise AssertionError(f'columns_per_second {cps:.4g} against phase '
                             f'5\'s {rates["surface"]:.4g} columns/s')
    log(f'[14 ingest] native.available(); levels_to_last of one '
        f'({LEVELS}, {GRID[0]}, {GRID[1]}) float32 variable, C++ equal to '
        f'numpy: C++ {cxx_a:.1f}/{cxx_b:.1f} ms, numpy (8 threads) '
        f'{numpy_a:.1f}/{numpy_b:.1f} ms, medians of 5 on '
        f'{os.cpu_count()} cores; utils.columns_per_second on the surface '
        f'solve {cps:.4g} columns/s ({cps_s * 1e3:.2f} ms a call, 5 calls '
        f'then one wait) against phase 5\'s {rates["surface"]:.4g} (median '
        f'of 5 waited calls), held to a factor of two: the solve is '
        f'host-bound and spreads that much between runs; {smi}')

    # 15. The JAX package's acceptance tiers through the kernels.
    counts = phase_tiers(dev, tab64, tab32, smi, kernel_ms, tail_ms,
                         rates['pipeline'])
    launches['fused_cape_cin'] += counts[0]
    launches['diag_tail'] += counts[1]

    record = {'kernels': [{
        'name': 'fused_cape_cin',
        'route': 'cuda',
        'source': 'xarray_parcel_tpu_torch/csrc/fused_cape.cu',
        'replaces': 'xarray_parcel_tpu/fused.py:159',
        'launches': launches['fused_cape_cin'],
        'max_abs_err': errs['float64'],
        'max_abs_err_float32': errs['float32'],
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': solve_bound[0],
        'bound_by': solve_bound[1],
        'library_ms': None,     # no single PyTorch call computes the solve
    }, {
        'name': 'diag_tail',
        'route': 'cuda',
        'source': 'xarray_parcel_tpu_torch/csrc/diag_tail.cu',
        'replaces': 'benchmarks/diag_kernel_ab.py:57',
        'launches': launches['diag_tail'],
        'max_abs_err': tail_errs['float64'],
        'max_abs_err_float32': tail_errs['float32'],
        'ms': tail_ms,
        'plain_ms': tail_plain_ms,
        'bound_ms': tail_bound[0],
        'bound_by': tail_bound[1],
        'library_ms': None,     # nor the tail
    }, {
        'name': 'parcel_prepass',
        'route': 'cuda',
        'source': 'xarray_parcel_tpu_torch/csrc/prepass.cu',
        'replaces': None,       # XLA fuses the JAX package's pre-pass
        'max_rel_err_float32': prepass_err,
        'ms': prepass_ms,
        'plain_ms': (pplain_a + pplain_b) / 2,
        'bound_ms': prepass_bound[0],
        'bound_by': prepass_bound[1],
        'library_ms': None,
    }, {
        'name': 'bridge_neighbors',
        'route': 'cuda',
        'source': 'xarray_parcel_tpu_torch/csrc/neighbors.cu',
        'replaces': None,       # XLA scans the JAX package's neighbours
        'bit_equal': True,
        **nb_rows['aus400_ml90'],
        'shapes': nb_rows,
    }, {
        'name': 'mix_layers',
        'route': 'cuda',
        'source': 'xarray_parcel_tpu_torch/csrc/mix_layer.cu',
        'replaces': None,       # XLA fuses the JAX package's mixed layers
        'launches': launches['mix_layers'],
        **mix_rows['aus400_ml90'],
        'shapes': mix_rows,
    }, {
        'name': 'most_unstable',
        'route': 'cuda',
        'source': 'xarray_parcel_tpu_torch/csrc/most_unstable.cu',
        'replaces': None,       # XLA fuses the JAX package's prep
        'launches': launches['most_unstable'],
        **mu_rows['aus400_ml90'],
        'shapes': mu_rows,
        'span_card_ms': span_rows,
    }]}
    log(json.dumps(record))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
