"""An ensemble on 13 pressure levels through ``parallel.scan_map``.

A batch already on the device that is too large to compute whole runs the
fused pipeline chunk by chunk: ``scan_map(conv_properties_fused, dat,
chunk_columns)``.  Here a tiny such batch on the CPU: several members of
columns on WeatherBench 2's 13 levels, each column with its own surface
pressure and every level below it NaN, as isobaric model output is masked,
run with ``ignore_nans=True``.  The chunked call must equal the whole call
bit for bit, with chunks of whole members and with chunks that do not
divide the batch (the last padded with NaN rows); it must agree with the
JAX package's pipeline under the float32 budget of the port's ground rules
(per output: NaN flips <= 1%, relative error of the float64 scale p95 <=
1e-4 and max <= 5e-4; boolean flips <= 5%); the wrapper's counters count
the chunks and padding rows that ran, also from many threads at once; and
under the profiler each chunk opens ``xparcel.chunked.slice`` once and each
call ``xparcel.chunked.gather`` once, with the pipeline's own spans outside
both.
"""

import math
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu_torch import AdiabatTables, pipeline
from xarray_parcel_tpu_torch.parallel import chunked, scan_map

from test_torch_spans import parents, traced_spans

LEVELS = np.array([1000.0, 925.0, 850.0, 700.0, 600.0, 500.0, 400.0, 300.0,
                   250.0, 200.0, 150.0, 100.0, 50.0])
MEMBERS, COLUMNS = 4, 12               # columns a member
B = MEMBERS * COLUMNS
# Two members a chunk (divides the batch), and a chunk that does not: 20,
# 20 and 8 columns, the last padded with 12 NaN rows.
CHUNKS = [2 * COLUMNS, 20]
G, RD, EPS = 9.80665, 287.04749097718457, 0.6219569100577033


def ensemble(seed=3):
    """(B, 13) float64 fields of ``MEMBERS`` members, member-major: each
    column's temperature from its own surface and lapse rate up to a
    tropopause, dewpoint from its own depression and drying aloft,
    hydrostatic heights and sheared winds; levels below the surface NaN in
    every level variable but the (broadcast) pressure."""
    rng = np.random.default_rng(seed)
    p = np.broadcast_to(LEVELS, (B, LEVELS.size))
    ps = rng.uniform(690.0, 1030.0, B)         # some columns on high ground
    ts = rng.uniform(283.0, 306.0, B)
    gamma = rng.uniform(5.0, 8.5, B)[:, None] / 1000.0
    t = ts[:, None] * (p / ps[:, None]) ** (RD * gamma / G)
    t = np.maximum(t, rng.uniform(200.0, 216.0, B)[:, None])
    t = t + rng.normal(0.0, 0.4, p.shape)
    above = np.clip(ps[:, None] - rng.uniform(30.0, 150.0, B)[:, None] - p,
                    0.0, None) / 100.0
    dep = rng.uniform(0.5, 12.0, B)[:, None] + rng.uniform(
        1.0, 9.0, B)[:, None] * above
    td = t - np.clip(dep + np.abs(rng.normal(0.0, 0.3, p.shape)), 0.1, 45.0)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = EPS * e / (p - e)
    zs = 8400.0 * np.log(1013.25 / ps)
    z = zs[:, None] + RD / G * 0.5 * (ts[:, None] + t) * np.log(
        ps[:, None] / p)
    frac = np.clip(z - zs[:, None], 0.0, 12000.0) / 6000.0
    us, vs = rng.normal(2.0, 4.0, B), rng.normal(0.0, 4.0, B)
    shear = rng.uniform(0.0, 30.0, B)[:, None]
    dat = {'temperature': t, 'specific_humidity': w / (1.0 + w),
           'height_asl': z, 'wind_height_above_surface': z - zs[:, None],
           'wind_u': us[:, None] + 0.8 * shear * frac,
           'wind_v': vs[:, None] + 0.6 * shear * frac}
    below = p > ps[:, None]
    assert below.any() and not below.all(axis=1).any()
    dat = {k: np.where(below, np.nan, v) for k, v in dat.items()}
    dat['pressure'] = p
    dat['surface_wind_u'], dat['surface_wind_v'] = us, vs
    return dat


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    t64 = AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                   torch.float64)
    return {torch.float64: t64, torch.float32: t64.astype(torch.float32)}


def columns(dtype):
    """The ensemble as tensors: the pressure the (B, 13) broadcast of the
    1-D levels, as the Dataset surface hands an isobaric coordinate."""
    dat = {k: torch.as_tensor(v, dtype=dtype) for k, v in ensemble().items()
           if k != 'pressure'}
    dat['pressure'] = torch.as_tensor(LEVELS, dtype=dtype).expand(
        B, LEVELS.size)
    return dat


def program(tables):
    def fn(d):
        return pipeline.conv_properties_fused(d, ignore_nans=True,
                                              tables=tables)
    return fn


def bits(x):
    """A tensor's bits, so that NaNs compare equal to themselves."""
    x = x.contiguous()
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.view(torch.int64) if x.dtype == torch.float64 else x


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
@pytest.mark.parametrize('chunk', CHUNKS, ids=['whole_members', 'padded'])
def test_scan_map_equals_the_whole_call_bitwise(tables, chunk, dtype):
    dat = columns(dtype)
    fn = program(tables[dtype])
    whole = fn(dat)
    got = scan_map(fn, dat, chunk)
    assert set(got) == set(whole) and len(got) > 20
    for k, v in whole.items():
        assert got[k].shape == v.shape == (B,) and got[k].dtype == v.dtype
        assert torch.equal(bits(got[k]), bits(v)), k


def test_chunked_agrees_with_jax_under_the_fp32_budget(tables, jax_tables):
    want = jpipeline.conv_properties_fused(
        {k: jnp.asarray(v) for k, v in ensemble().items()},
        ignore_nans=True, tables=jax_tables)
    got = scan_map(program(tables[torch.float32]), columns(torch.float32),
                   CHUNKS[1])
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = np.asarray(want[k]), got[k].numpy()
        if a.dtype == bool:
            assert np.mean(a != b) <= 0.05, f'{k}: boolean flips'
            continue
        b = b.astype(np.float64)
        assert np.mean(np.isnan(a) != np.isnan(b)) <= 0.01, f'{k}: NaN flips'
        both = ~np.isnan(a) & ~np.isnan(b)
        if not both.any():
            continue
        scale = max(1.0, float(np.nanmax(np.abs(a))))
        d = np.abs(a[both] - b[both]) / scale
        p95 = float(np.quantile(d, 0.95))
        assert p95 <= 1e-4, f'{k}: p95 {p95:.2e}'
        assert float(d.max()) <= 5e-4, f'{k}: max {d.max():.2e}'


@pytest.mark.parametrize('chunk', CHUNKS, ids=['whole_members', 'padded'])
def test_counters_count_what_ran(tables, chunk):
    dat = columns(torch.float32)
    wrapped = chunked(program(tables[torch.float32]), chunk)
    assert (wrapped.chunks, wrapped.padded_rows) == (0, 0)
    n = math.ceil(B / chunk)
    seen = [(0, 0)]
    for call in (1, 2):
        wrapped(dat)
        seen.append((wrapped.chunks, wrapped.padded_rows))
        assert seen[-1] == (call * n, call * (n * chunk - B))
    # The counts only rise, and each wrapper keeps its own.
    assert seen == sorted(seen) and seen[1] < seen[2]
    other = chunked(program(tables[torch.float32]), chunk)
    other({k: v[:chunk] for k, v in dat.items()})
    assert (other.chunks, other.padded_rows) == (1, 0)
    assert (wrapped.chunks, wrapped.padded_rows) == seen[-1]


@pytest.mark.parametrize('chunk', CHUNKS, ids=['whole_members', 'padded'])
def test_spans_slice_each_chunk_and_gather_once(tables, chunk, tmp_path):
    dat = columns(torch.float32)
    fn = program(tables[torch.float32])
    plain = scan_map(fn, dat, chunk)
    traced, spans = traced_spans(lambda: scan_map(fn, dat, chunk), tmp_path)
    n = math.ceil(B / chunk)
    names = [name for _, _, name in spans]
    assert names.count('xparcel.chunked.slice') == n
    assert names.count('xparcel.chunked.gather') == 1
    assert names.count('xparcel.pipeline') == n
    for name, parent in parents(spans):
        if name.startswith('xparcel.chunked.'):
            assert parent is None, (name, parent)
        else:                   # the program runs outside both spans
            assert not (parent or '').startswith('xparcel.chunked.'), name
    # The gather closes the call: it starts after the last chunk's program.
    gather = next(s for s in spans if s[2] == 'xparcel.chunked.gather')
    assert all(a < gather[0] for a, _, name in spans
               if name == 'xparcel.pipeline')
    for k in plain:
        assert torch.equal(bits(plain[k]), bits(traced[k])), k


def test_counters_lose_no_count_across_threads():
    """One wrapper called from more threads than cores, switching often,
    as ``sharded_map`` calls a program from a thread per mesh entry."""
    wrapped = chunked(lambda d: {'x': d['x'] * 2}, 3)
    dat = {'x': torch.arange(7.0)}           # 3 chunks, 2 padding rows
    threads, calls = 32, 40
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [wrapped(dat) for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(before)
    n = threads * calls
    assert (wrapped.chunks, wrapped.padded_rows) == (3 * n, 2 * n)
