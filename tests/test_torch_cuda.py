"""The CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and ``nvcc``: the kernels have no CPU mode.
Without a card they skip.  Where JAX is not installed, run them without
the JAX-configuring ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from xarray_parcel_tpu_torch import (AdiabatTables, adiabat, fused, parcels,
                                     thermo)
from xarray_parcel_tpu_torch import diagnostics as diag
from xarray_parcel_tpu_torch import pipeline as xt_pipeline
from xarray_parcel_tpu_torch import xarray_api as xapi
from xarray_parcel_tpu_torch.parallel import stream_map

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel runs only on the card')
    return torch.device('cuda', 0)


@pytest.fixture(scope='module')
def coeffs(device):
    return adiabat.build_spectral(device)


# Widths around the lanes' wrap (a warp strides over a column's levels
# 32 at a time) and the main path's 90.
WIDTHS = [6, 31, 32, 33, 57, 90, 137]


@pytest.mark.parametrize('L', WIDTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_kernel_matches_twin(device, coeffs, dtype, L):
    """Identical NaN patterns; float64 within 1e-6, float32 within the
    float32 budget (chip_smoke.compare), on hard columns whose LCL slot,
    duplicated levels, NaN gaps and tied LFC/EL candidates straddle lanes
    31/32 and 63/64, with flood, all-NaN and k0-near-L columns; 4 x 301
    columns, not a multiple of the columns a block holds."""
    tables = AdiabatTables(coeffs.to(dtype))
    args = chip_smoke.lane_edge_args(301, tables, L=L, seed=L)
    got = fused.cape_cin_kernel(*args)
    torch.cuda.synchronize()
    want = fused._column_outputs(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    chip_smoke.compare('kernel', dict(zip(fused.OUTPUTS, got)),
                       dict(zip(fused.OUTPUTS, want)), str(dtype)[6:])


def tall_columns(n, L, seed):
    """``chip_smoke.synthetic_columns`` interpolated in log-pressure onto
    L levels (float64 p, t, td): the same soundings, finely resolved."""
    p, t, td = (x.astype(np.float64)
                for x in chip_smoke.synthetic_columns(n, seed=seed))
    fine = np.geomspace(p[0, 0], p[0, -1], L)
    x, xs = np.log(p[0])[::-1], np.log(fine)[::-1]
    return (np.broadcast_to(fine, (n, L)).copy(),
            *(np.stack([np.interp(xs, x, v[::-1])[::-1] for v in f])
              for f in (t, td)))


def test_kernel_takes_any_width(device, coeffs):
    """Columns too tall for one block's shared memory (12,000 float64
    levels): their slots pass through the warp's buffer in windows; the
    tail at the same width."""
    tables = AdiabatTables(coeffs)
    args = chip_smoke.kernel_args(*(
        torch.as_tensor(x, device=device)
        for x in tall_columns(3, 12_000, seed=2)), tables)
    got, prof = fused.cape_cin_kernel(*args, with_profile=True)
    torch.cuda.synchronize()
    want, want_prof = fused._column_outputs(*args, with_profile=True)
    chip_smoke.compare('kernel', dict(zip(fused.OUTPUTS, got)),
                       dict(zip(fused.OUTPUTS, want)), 'float64')
    chip_smoke.compare('profile', dict(zip(fused.PROFILE, prof)),
                       dict(zip(fused.PROFILE, want_prof)), 'float64')
    assert (got[0] > 0).any()                   # convective columns
    cols = [torch.as_tensor(x, device=device)
            for x in chip_smoke.tail_columns(5, L=12_000, seed=2)]
    chip_smoke.compare('tail', dict(zip(diag.DIAG_OUTPUTS,
                                        diag.diag_kernel(*cols))),
                       dict(zip(diag.DIAG_OUTPUTS, diag._diag_body(*cols))),
                       'float64')


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_prepass_kernel_matches_twin(device, coeffs, dtype):
    """Equal k0 and NaN patterns, rows and scalars within 1e-5 (float32)
    and 1e-11 (float64) of scale (chip_smoke.compare_prepass), on
    chip_smoke.prepass_args: the hard columns' parcels, NaN parcels,
    parcels outside the adiabat family (NaN rows), NaN-led pressure
    columns (k0 > 0) and all-NaN columns; 4 x 301 columns, not a multiple
    of the columns a block holds."""
    tables = AdiabatTables(coeffs.to(dtype))
    args = chip_smoke.prepass_args(301, L=57, seed=3, dtype=dtype,
                                   device=device)
    before = fused.prepass_kernel.launches
    row, scalars, k0 = fused.prepass_kernel(*args, tables)
    torch.cuda.synchronize()
    assert fused.prepass_kernel.launches == before + 1
    want = fused._prepass_twin(*args, tables)
    chip_smoke.compare_prepass('prepass', (row, scalars, k0), want)
    assert (k0 > 0).any() and torch.isnan(want[0]).all(-1).any()


def test_prepass_launches_per_pipeline(device, coeffs):
    """One pre-pass launch a solve: 3 a conv_properties_fused call, 1 a
    min_conv_properties_fused call."""
    tables = AdiabatTables(coeffs.to(torch.float32))
    dat_np, _ = chip_smoke.synthetic(500, L=40)
    dat = {k: torch.as_tensor(v, device=device) for k, v in dat_np.items()}
    for run, want in ((xt_pipeline.conv_properties_fused, 3),
                      (xt_pipeline.min_conv_properties_fused, 1)):
        before = fused.prepass_kernel.launches
        run(dat, tables=tables)
        assert fused.prepass_kernel.launches == before + want


# --- the neighbours kernel (parcels.bridge_neighbors) -----------------------

NEIGHBOR_WIDTHS = [1, 2, 13, 35, 90, 137]


def neighbors_both(p, valid):
    """The kernel's (prev, next), with one launch counted, and the twin's
    on the card."""
    before = parcels.bridge_neighbors_kernel.launches
    got = parcels.bridge_neighbors_kernel(p, valid)
    torch.cuda.synchronize()
    assert parcels.bridge_neighbors_kernel.launches == before + 1
    return got, parcels._bridge_neighbors_twin(p, valid)


@pytest.mark.parametrize('L', NEIGHBOR_WIDTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_neighbors_kernel_matches_twin(device, dtype, L):
    """Bit for bit, NaN where the twin has NaN, on
    chip_smoke.neighbor_columns: NaN-led prefixes, interior invalid runs,
    all-invalid and all-NaN rows, NaN under a True valid, ties, unsorted
    rows with +-inf; 1,003 rows, not a multiple of a block's tile."""
    p, valid = chip_smoke.neighbor_columns(1003, L, seed=L, dtype=dtype,
                                           device=device)
    chip_smoke.same_bits(f'neighbors L={L}', *neighbors_both(p, valid))


@pytest.mark.parametrize('layout', ['broadcast_1d', 'broadcast_rows',
                                    'level_stride', 'transposed', 'grid'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_neighbors_kernel_layouts(device, dtype, layout):
    """A stride-0 pressure (1-D levels, and their (B, L) broadcast), read in
    place; pressures with a level stride of 2 and column-major, copied; a
    (ny, nx, L) batch: each bit-equal with the twin, in the mask's shape."""
    p, valid = chip_smoke.neighbor_columns(777, 35, seed=4, dtype=dtype,
                                           device=device)
    if layout.startswith('broadcast'):
        p = torch.linspace(1000.0, 3.0, 35, dtype=dtype, device=device)
        p[7] = p[6]                             # a tie
        p[20] = torch.nan                       # NaN where valid or not
        if layout == 'broadcast_rows':
            p = p.expand(valid.shape)
    elif layout == 'level_stride':
        p = torch.stack([p, p], -1).flatten(-2)[..., ::2]
    elif layout == 'transposed':
        p = p.t().contiguous().t()
    else:
        p, valid = p.reshape(21, 37, 35), valid.reshape(21, 37, 35)
    got, want = neighbors_both(p, valid)
    assert got[0].shape == valid.shape
    chip_smoke.same_bits(f'neighbors {layout}', got, want)


def test_neighbors_kernel_long_rows(device):
    """Rows too long for a tile of several (12,000 float64 levels): a row a
    block, in opt-in shared memory."""
    p, valid = chip_smoke.neighbor_columns(9, 12_000, seed=2, device=device)
    chip_smoke.same_bits('neighbors long rows', *neighbors_both(p, valid))


def test_neighbors_launches_per_pipeline(device, coeffs):
    """No neighbours launch in a conv_properties_fused or a
    min_conv_properties_fused call, and one mixed-layer launch, which
    scans the neighbours of every depth itself; with ``mix_grow``, one
    neighbours launch (the mixed layers share it) and no mixed-layer
    launch."""
    tables = AdiabatTables(coeffs.to(torch.float32))
    dat_np, _ = chip_smoke.synthetic(500, L=40)
    dat = {k: torch.as_tensor(v, device=device) for k, v in dat_np.items()}
    for run, want in (
            (xt_pipeline.conv_properties_fused, (0, 1)),
            (xt_pipeline.min_conv_properties_fused, (0, 1)),
            (lambda d, **kw: xt_pipeline.conv_properties_fused(
                d, mix_grow=True, **kw), (1, 0))):
        before = (parcels.bridge_neighbors_kernel.launches,
                  parcels.mix_layers_kernel.launches)
        run(dat, tables=tables)
        assert (parcels.bridge_neighbors_kernel.launches - before[0],
                parcels.mix_layers_kernel.launches - before[1]) == want


def era5_style(n, L=35, seed=6):
    """chip_smoke.synthetic columns on the (n, L) broadcast of 1-D levels,
    each column's levels below a drawn surface NaN in temperature,
    humidity and height (NaN-led columns, as ERA5 on pressure levels has
    them)."""
    dat_np, _ = chip_smoke.synthetic(n, L=L, seed=seed)
    ground = np.random.default_rng(seed).integers(0, 6, n)
    below = np.arange(L) < ground[:, None]
    dat = {k: torch.as_tensor(np.where(below, np.nan, v).astype(v.dtype)
                              if k in ('temperature', 'specific_humidity',
                                       'height_asl')
                              else np.ascontiguousarray(v))
           for k, v in dat_np.items()}
    dat['pressure'] = dat['pressure'][0].expand(n, L)
    return dat


@pytest.mark.parametrize('columns', ['synthetic', 'era5_style'])
def test_pipeline_bit_equal_with_the_twin(device, coeffs, columns,
                                          monkeypatch):
    """conv_properties_fused on the card, with the mixed-layer kernel and
    with its twin in its place: every output that does not read the mixed
    parcels bit for bit, NaN where NaN; the mixed parcels' CAPE, CIN,
    lifted index and DCI within the float32 budget (chip_smoke.compare:
    the parcels' sums add in another order)."""
    tables = AdiabatTables(coeffs.to(torch.float32))
    if columns == 'synthetic':
        dat_np, _ = chip_smoke.synthetic(4099, L=90, seed=5)
        dat = {k: torch.as_tensor(np.ascontiguousarray(v))
               for k, v in dat_np.items()}
    else:
        dat = era5_style(4099)
    dat = {k: v.to(device) for k, v in dat.items()}
    kw = dict(tables=tables, ignore_nans=columns == 'era5_style')
    before = parcels.mix_layers_kernel.launches
    got = xt_pipeline.conv_properties_fused(dat, **kw)
    assert parcels.mix_layers_kernel.launches == before + 1
    monkeypatch.setattr(parcels, 'mix_layers_kernel',
                        parcels._mix_layers_twin)
    want = xt_pipeline.conv_properties_fused(dat, **kw)
    assert set(got) == set(want)
    mixed = sorted(k for k in want if k.startswith('mixed_'))
    for k in want:
        if want[k].dtype == torch.bool:
            assert torch.equal(got[k], want[k]), k
        elif k not in mixed:
            chip_smoke.same_bits(k, (got[k],), (want[k],))
    chip_smoke.compare('mixed parcels', {k: got[k] for k in mixed},
                       {k: want[k] for k in mixed}, 'float32')
    if columns == 'era5_style':
        assert torch.isfinite(got['mu_cape']).any()
        assert torch.isfinite(got['mixed_100_cape']).any()


@pytest.mark.parametrize('L', WIDTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_profile_tracks_match_twin(device, coeffs, dtype, L):
    """The solve's profile tracks against the twin's, and the lifted index
    interpolated from them against the in-kernel one, on the columns of
    test_kernel_matches_twin."""
    tables = AdiabatTables(coeffs.to(dtype))
    args = chip_smoke.lane_edge_args(301, tables, L=L, seed=L)
    out, prof = fused.cape_cin_kernel(*args, with_profile=True)
    torch.cuda.synchronize()
    assert prof.shape == (3, args[0].shape[0], L + 1)
    assert torch.equal(out.nan_to_num(7.0),
                       fused.cape_cin_kernel(*args).nan_to_num(7.0))
    _, want = fused._column_outputs(*args, with_profile=True)
    assert torch.equal(torch.isnan(prof), torch.isnan(want))
    name = str(dtype)[6:]
    chip_smoke.compare('profile', dict(zip(fused.PROFILE, prof)),
                       dict(zip(fused.PROFILE, want)), name)
    li = diag.lifted_index(dict(zip(fused.PROFILE, prof)))['lifted_index']
    chip_smoke.compare('profile LI', li, out[-1], name)


@pytest.mark.parametrize('L', WIDTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_tail_kernel_matches_twin(device, dtype, L):
    """Identical NaN patterns and chip_smoke.compare's bounds, on hard
    tail columns whose anchor levels, 0 C crossings and NaN levels
    straddle lanes 31/32 and 63/64; 517 columns."""
    cols = [torch.as_tensor(x, dtype=dtype, device=device)
            for x in chip_smoke.lane_edge_tail_columns(517, L=L, seed=L)]
    got = diag.diag_kernel(*cols)
    torch.cuda.synchronize()
    want = torch.stack(diag._diag_body(*cols))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    chip_smoke.compare('tail', dict(zip(diag.DIAG_OUTPUTS, got)),
                       dict(zip(diag.DIAG_OUTPUTS, want)), str(dtype)[6:])


# --- the mixed-layer kernel (parcels.mix_layers) -----------------------------

MIX_WIDTHS = [1, 2, 13, 35, 90, 137]
# ERA5's isobaric levels down to 3 hPa: both layer tops of a 1000 hPa
# bottom (900, 950) are levels.
ERA5_LEVELS = [1000, 975, 950, 925, 900, 875, 850, 825, 800, 775, 750, 700,
               650, 600, 550, 500, 450, 400, 350, 300, 250, 225, 200, 175,
               150, 125, 100, 70, 50, 30, 20, 10, 7, 5, 3]


def mix_held(name, p, t, td, depths):
    """The kernel's outputs, with one launch counted, held to the twin's on the card (chip_smoke.compare_mix; in float32
    beside the twin's in float64 on the same inputs).  Returns the
    kernel's outputs."""
    before = parcels.mix_layers_kernel.launches
    got = parcels.mix_layers_kernel(p, t, td, depths)
    torch.cuda.synchronize()
    launches = parcels.mix_layers_kernel.launches - before
    assert launches == 1
    chip_smoke.compare_mix(name, got, parcels._mix_layers_twin(
        p, t, td, depths), depths, chip_smoke.mix_exact(p, t, td, depths))
    return got


@pytest.mark.parametrize('depths', [(100.0,), (100.0, 50.0)])
@pytest.mark.parametrize('L', MIX_WIDTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_mix_layers_kernel_matches_twin(device, dtype, L, depths):
    """The kernel held to the twin on chip_smoke.mix_columns' hard rows
    (NaN-led, interior-NaN and trailing-NaN columns, all-NaN columns,
    duplicated levels, levels on the layer tops, one valid level in the
    layer or none, bottoms under 100 hPa, unsorted rows), a contiguous
    pressure; 1,003 rows, not a multiple of a block's tile."""
    p, t, td = chip_smoke.mix_columns(1003, L, seed=L, dtype=dtype,
                                      device=device)
    mix_held(f'mix L={L}', p, t, td, depths)


@pytest.mark.parametrize('layout', ['broadcast_1d', 'broadcast_rows',
                                    'transposed', 'grid'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_mix_layers_kernel_layouts(device, dtype, layout):
    """A stride-0 pressure (ERA5's 1-D levels, and their (B, L) broadcast)
    read in place under temperature and dewpoint NaN below each column's
    ground; a column-major pressure, copied; a (ny, nx, L) batch: each held
    to the twin, every output in the full shape."""
    depths = (100.0, 50.0)
    p, t, td = chip_smoke.mix_columns(777, 35, seed=4, dtype=dtype,
                                      device=device)
    if layout.startswith('broadcast'):
        p = torch.tensor(ERA5_LEVELS, dtype=dtype, device=device)
        ground = torch.arange(777, device=device) % 6
        below = torch.arange(35, device=device) < ground[:, None]
        t, td = (x.masked_fill(below, torch.nan) for x in (t, td))
        if layout == 'broadcast_rows':
            p = p.expand(t.shape)
    elif layout == 'transposed':
        p = p.t().contiguous().t()
    else:
        p, t, td = (x.reshape(21, 37, 35) for x in (p, t, td))
    got = mix_held(f'mix {layout}', p, t, td, depths)
    assert all(g.shape == t.shape for g in got[0::6])
    assert all(g.shape == t.shape[:-1] for g in got[3::6])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_mix_layers_gradient_with_1d_pressure(device, dtype):
    """A 1-D pressure that requires grad, as on the CPU
    (test_torch_pipeline): the kernel's outputs in the full shape, and
    every input's gradient (the twin's VJP) equal to the twin's own
    autograd on the card, the pressure's in its (L,) shape, up to the
    order of the neighbour scans' atomic sums."""
    p, t, td = (x[::15] for x in chip_smoke.mix_columns(
        1500, 35, seed=8, dtype=dtype, device=device))
    depths = (100.0, 50.0)

    def grads(fn):
        xs = [p[0].clone().requires_grad_(), t.clone().requires_grad_(),
              td.clone().requires_grad_()]
        outs = fn(*xs, depths)
        loss = sum((torch.where(torch.isfinite(o), o, 0.0) * (k + 1)).sum()
                   for k, o in enumerate(outs))
        return outs, torch.autograd.grad(loss, xs, allow_unused=True)

    outs, got = grads(parcels.mix_layers_kernel)
    assert outs[0].grad_fn.kernel is parcels.mix_layers_kernel
    assert all(o.shape == t.shape for o in outs[0::6])
    _, want = grads(parcels._mix_layers_twin)
    assert got[0].shape == p[0].shape and got[0].abs().sum() > 0
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, equal_nan=True)


def test_mix_layers_kernel_long_rows(device):
    """Rows too long for a tile of several (6,000 float64 levels, 198 KB of
    shared memory): a row a block, in opt-in shared memory, its levels
    over the 32 lanes of a warp."""
    depths = (100.0, 50.0)
    p, t, td = chip_smoke.mix_columns(9, 6_000, seed=2, device=device)
    mix_held('mix long rows', p, t, td, depths)


# --- the most-unstable kernel (parcels.from_most_unstable_parcel) -----------

def mu_held(name, p, t, td, depth):
    """The kernel's outputs, with one launch counted, held bit for bit to
    the twin's on the card (chip_smoke.same_bits).  Returns them."""
    before = parcels.most_unstable_kernel.launches
    got = parcels.most_unstable_kernel(p, t, td, depth)
    torch.cuda.synchronize()
    assert parcels.most_unstable_kernel.launches == before + 1
    chip_smoke.same_bits(name, got,
                         parcels._most_unstable_twin(p, t, td, depth))
    return got


@pytest.mark.parametrize('depth', chip_smoke.MU_DEPTHS)
@pytest.mark.parametrize('L', chip_smoke.MU_LEVELS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_most_unstable_kernel_matches_twin(device, dtype, L, depth):
    """The kernel bit for bit the twin on chip_smoke.mu_columns' hard rows
    (NaN-led, interior-NaN and all-NaN columns, no temperature, ties of
    theta-e and of the layer's bound, a layer of one level, duplicated,
    unsorted and reversed levels, levels on the bound), a contiguous
    pressure; 1,003 rows, not a multiple of a block's tile."""
    p, t, td = chip_smoke.mu_columns(1003, L, seed=L, dtype=dtype,
                                     device=device)
    mu_held(f'most-unstable L={L} depth={depth}', p, t, td, depth)


@pytest.mark.parametrize('layout', ['broadcast_1d', 'broadcast_rows',
                                    'transposed', 'grid'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_most_unstable_kernel_layouts(device, dtype, layout):
    """A stride-0 pressure (ERA5's 1-D levels, and their (B, L) broadcast)
    read in place under temperature and dewpoint NaN below each column's
    ground; a column-major pressure, copied; a (ny, nx, L) batch: each bit
    for bit the twin, every output in the full shape."""
    p, t, td = chip_smoke.mu_columns(777, 35, seed=4, dtype=dtype,
                                     device=device)
    if layout.startswith('broadcast'):
        p = torch.tensor(ERA5_LEVELS, dtype=dtype, device=device)
        ground = torch.arange(777, device=device) % 6
        below = torch.arange(35, device=device) < ground[:, None]
        t, td = (x.masked_fill(below, torch.nan) for x in (t, td))
        if layout == 'broadcast_rows':
            p = p.expand(t.shape)
    elif layout == 'transposed':
        p = p.t().contiguous().t()
    else:
        p, t, td = (x.reshape(21, 37, 35) for x in (p, t, td))
    got = mu_held(f'most-unstable {layout}', p, t, td, 250.0)
    assert all(g.shape == t.shape for g in got[:3])
    assert all(g.shape == t.shape[:-1] for g in got[3:])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_most_unstable_kernel_ties(device, dtype):
    """The kernel's tie rules on the card: of two levels whose theta-e
    (thermo's, on the card) is equal the first is the parcel; of two
    levels equally far from the layer's bound the larger pressure bounds
    the layer, leaving the most unstable level, below it, out."""
    p, t, td = chip_smoke.mu_columns(320, 35, seed=5, dtype=dtype,
                                     device=device)
    kind = torch.arange(320, device=device) % chip_smoke.MU_KINDS
    e = thermo.equivalent_potential_temperature(p[:, :2], t[:, :2],
                                                td[:, :2])
    tie = (kind == 13) & (e[:, 0] == e[:, 1])
    assert int(tie.sum()) >= 16 and (t[tie, 0] != t[tie, 1]).all()
    got = mu_held('most-unstable ties', p, t, td, 250.0)
    assert torch.equal(got[4][tie], t[tie, 0])
    for k, depth in zip((7, 8), chip_smoke.MU_DEPTHS):
        rows = kind == k
        got = mu_held(f'most-unstable bound ties {depth}', p, t, td, depth)
        hot = p[rows] == (p[rows, :1] - depth - 2.0)
        assert (hot.sum(-1) == 1).all()
        assert (got[3][rows] > p[rows][hot]).all()


@pytest.mark.parametrize('L', [6_000, 12_000])
def test_most_unstable_kernel_long_rows(device, L):
    """Rows too long for a tile of several: a row a block, its levels over
    the 32 lanes of a warp, in opt-in shared memory (6,000 float64
    levels) or, too long for it (12,000, as the solve's any-width test
    makes them), read in place."""
    p, t, td = chip_smoke.mu_columns(9, L, seed=2, device=device)
    for depth in chip_smoke.MU_DEPTHS:
        mu_held('most-unstable long rows', p, t, td, depth)


@pytest.mark.parametrize('case', chip_smoke.MU_INPUTS)
def test_from_most_unstable_parcel_takes_what_the_plain_ops_take(device,
                                                                  case):
    """Inputs of chip_smoke.mu_inputs, which the plain ops take and the
    kernel does not: one launch, each output in its input's dtype and in
    the full shape, bit for bit the twin's on the card on the inputs made
    what the kernel takes (parcels._card_inputs), its outputs cast back."""
    p, t, td, depth = chip_smoke.mu_inputs(case, device)
    before = parcels.most_unstable_kernel.launches
    fields, parcel = parcels.from_most_unstable_parcel(p, t, td, depth)
    assert parcels.most_unstable_kernel.launches == before + 1
    got = (*fields.values(), *parcel.values())
    want = parcels._most_unstable_twin(*parcels._card_inputs(p, t, td,
                                                             depth))
    dtypes = [x.dtype for x in (p, t, td)] * 2
    assert [o.dtype for o in got] == dtypes
    assert [o.shape for o in got] == [(40, 35)] * 3 + [(40,)] * 3
    chip_smoke.same_bits(f'most-unstable {case}', got,
                         [w.to(d) for w, d in zip(want, dtypes)])


def test_column_kernels_refuse_no_levels(device):
    """Columns of no levels: the mixed-layer and most-unstable kernels
    raise ValueError, launching nothing, where the twins raise too, rather
    than return an unwritten parcel."""
    p = torch.empty(3, 0, device=device)
    for kernel, extra in ((parcels.most_unstable_kernel, 250.0),
                          (parcels.mix_layers_kernel, (100.0,))):
        before = kernel.launches
        with pytest.raises(ValueError, match='one level'):
            kernel(p, p, p, extra)
        assert kernel.launches == before


@pytest.mark.parametrize('columns', ['synthetic', 'era5_style'])
def test_pipeline_bit_equal_with_the_most_unstable_twin(device, coeffs,
                                                        columns, monkeypatch):
    """conv_properties_fused on the card, one most-unstable launch a call
    (none for the reduced pipeline, one for the modular one), and with the
    kernel's twin in its place: every output bit for bit, NaN where
    NaN."""
    tables = AdiabatTables(coeffs.to(torch.float32))
    if columns == 'synthetic':
        dat_np, _ = chip_smoke.synthetic(4099, L=90, seed=5)
        dat = {k: torch.as_tensor(np.ascontiguousarray(v))
               for k, v in dat_np.items()}
    else:
        dat = era5_style(4099)
    dat = {k: v.to(device) for k, v in dat.items()}
    kw = dict(tables=tables, ignore_nans=columns == 'era5_style')
    before = parcels.most_unstable_kernel.launches
    got = xt_pipeline.conv_properties_fused(dat, **kw)
    assert parcels.most_unstable_kernel.launches == before + 1
    xt_pipeline.min_conv_properties_fused(dat, tables=tables)
    assert parcels.most_unstable_kernel.launches == before + 1
    xt_pipeline.conv_properties(dat, tables=tables)
    assert parcels.most_unstable_kernel.launches == before + 2
    monkeypatch.setattr(parcels, 'most_unstable_kernel',
                        parcels._most_unstable_twin)
    want = xt_pipeline.conv_properties_fused(dat, **kw)
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype == torch.bool:
            assert torch.equal(got[k], want[k]), k
        else:
            chip_smoke.same_bits(k, (got[k],), (want[k],))
    assert torch.isfinite(got['mu_cape']).any()


# --- every kernel through the seam (_kernels) --------------------------------

KERNELS = ['solve', 'prepass', 'tail', 'neighbors', 'mix',
           'most_unstable']


def card_case(name, device, coeffs, n=40, L=30):
    """A kernel, its arguments on the card (n columns of L levels), and a
    call of the pipeline function that reaches it once on the first k of
    those columns, returning that function's first output and its
    expected shape."""
    tables = AdiabatTables(coeffs)

    def first(k, xs):
        return tuple(x[:k] if torch.is_tensor(x) else x for x in xs)

    if name == 'solve':
        p, t, td = (torch.as_tensor(x, device=device)
                    for x in chip_smoke.hard_columns(n, L=L))
        args = (p, t, td, *fused.prepass(p, p[:, 0], t[:, 0], td[:, 0],
                                         tables))
        return fused.cape_cin_kernel, args, lambda k: (
            fused.fused_surface_cape_cin(
                *first(k, (p, t, td)), tables=tables)[0]['cape'], (k,))
    if name == 'prepass':
        # prepass_args gives four parcel variants of each column.
        args = (*chip_smoke.prepass_args(n // 4, L=L, device=device),
                tables)
        return fused.prepass_kernel, args, lambda k: (
            fused.prepass(*first(k, args))[0], (k, adiabat.N_COEF))
    if name == 'tail':
        args = tuple(torch.as_tensor(x, device=device)
                     for x in chip_smoke.tail_columns(n, L=L))
        return diag.diag_kernel, args, lambda k: (
            diag.diag_fused(*(x.reshape(4, k // 4, L)
                              for x in first(k, args)))[0], (4, k // 4))
    if name == 'neighbors':
        args = chip_smoke.neighbor_columns(n, L, device=device)
        return parcels.bridge_neighbors_kernel, args, lambda k: (
            parcels.bridge_neighbors(*first(k, args))[0], (k, L))
    if name == 'mix':
        args = (*chip_smoke.mix_columns(n, L, device=device), (100.0, 50.0))
        return parcels.mix_layers_kernel, args, lambda k: (
            parcels.mix_layers(*first(k, args))[0][0]['pressure'], (k, L))
    args = (*chip_smoke.mu_columns(n, L, device=device), 250.0)
    return parcels.most_unstable_kernel, args, lambda k: (
        parcels.from_most_unstable_parcel(*first(k, args))[1]['pressure'],
        (k,))


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize('name', KERNELS)
def test_launch_counter_and_empty_batch(device, coeffs, name):
    """One launch a call, counted, from the pipeline function and from the
    kernel itself, outputs on the card; B = 0, through either, launches
    nothing and returns the outputs with an empty batch."""
    kernel, args, call = card_case(name, device, coeffs)
    before = kernel.launches
    out, shape = call(40)
    assert kernel.launches == before + 1
    assert out.shape == shape and out.device == device
    out, shape = call(0)
    assert kernel.launches == before + 1
    assert out.shape == shape and out.device == device
    full = outputs(kernel(*args))
    assert kernel.launches == before + 2
    empty = outputs(kernel(*(x[:0] if torch.is_tensor(x) else x
                             for x in args)))
    assert kernel.launches == before + 2
    assert [o.shape for o in empty] == [
        tuple(0 if s == 40 else s for s in o.shape) for o in full]
    assert all(o.device == device for o in full + empty)


def rejected(name, args):
    """(arguments, exception) the kernel must raise on without a launch:
    those of every kernel (a device that is neither CUDA nor the CPU, a
    CPU/CUDA mix, half floats), then the kernel's own."""
    def swap(i, x):
        return tuple(x if j == i else a for j, a in enumerate(args))

    floats = tuple(x.half() if torch.is_tensor(x) and x.is_floating_point()
                   else x for x in args)
    common = [(tuple(x.to('meta') if torch.is_tensor(x) else x
                     for x in args), ValueError),
              (swap(0, args[0].cpu()), TypeError),
              (swap(1, args[1].cpu()), TypeError),
              (floats, TypeError)]
    if name == 'solve':
        p, t, td, row, scalars, k0 = args
        own = [(swap(0, p.float()), TypeError),
               (swap(5, k0.long()), TypeError),
               (swap(1, t[:, :-1]), ValueError),
               (swap(3, row[:, :40]), ValueError)]
    elif name == 'prepass':
        own = [(swap(1, args[1].float()), TypeError),
               (swap(1, args[1][:-1]), ValueError)]
    elif name == 'tail':
        own = [(swap(0, args[0].float()), TypeError),
               (swap(1, args[1][:, :-1]), ValueError),
               (tuple(x[0] for x in args), ValueError)]
    elif name == 'neighbors':
        p, valid = args
        own = [(swap(1, valid.to(torch.uint8)), TypeError),
               (swap(1, valid[:, :-1]), ValueError),
               (swap(1, valid[0]), ValueError)]
    elif name == 'mix':
        p, t, td, depths = args
        own = [(swap(0, p.float()), TypeError),
               (swap(0, p[:, :-1]), ValueError),
               (swap(2, td[:-1]), ValueError),
               (swap(3, ()), ValueError),
               (swap(3, (150.0, 100.0, 50.0)), ValueError)]
    else:
        p, t, td, depth = args
        own = [(swap(0, p.float()), TypeError),
               (swap(0, p[:, :-1]), ValueError),
               (swap(2, td[:-1]), ValueError),
               (swap(1, t[0]), ValueError)]
    return common + own


@pytest.mark.parametrize('name', KERNELS)
def test_wrapper_rejects_what_the_kernel_does_not_take(device, coeffs, name):
    kernel, args, _ = card_case(name, device, coeffs, n=20)
    before = kernel.launches
    for bad, error in rejected(name, args):
        with pytest.raises(error):
            kernel(*bad)
    # The last tensor input on the CPU, given by keyword (k0 for the solve).
    names = list(kernel.signature.parameters)
    last = max(i for i, x in enumerate(args) if torch.is_tensor(x))
    with pytest.raises(TypeError):
        kernel(*args[:last], **{names[last]: args[last].cpu()},
               **dict(zip(names[last + 1:], args[last + 1:])))
    assert kernel.launches == before


def solve_gradient(device, coeffs):
    """Through fused_cape_cin with the four parcel variants: the card's
    gradient (the twin's VJP on the card) against the CPU's."""
    cols, parcel = chip_smoke.variant_columns(*(
        torch.as_tensor(x, device=device)
        for x in chip_smoke.hard_columns(301, L=57, seed=3)))

    def grads(dev):
        leaves = [x.detach().to(dev).requires_grad_()
                  for x in (*cols.values(), *parcel.values())]
        res, _ = fused.fused_cape_cin(
            *leaves[:3], parcel_pressure=leaves[3],
            parcel_temperature=leaves[4], parcel_dewpoint=leaves[5],
            tables=AdiabatTables(coeffs.to(dev)), with_lifted_index=True)
        loss = chip_smoke.finite_sum(res, ('cape', 'cin', 'lifted_index'))
        return torch.autograd.grad(loss, leaves)

    def check(got, want):
        chip_smoke.compare_grads(
            'solve gradient', got, want,
            skip=chip_smoke.repeated_level(cols['pressure']))

    return ((fused.cape_cin_kernel, fused.prepass_kernel),
            lambda: grads(device), lambda: grads('cpu'), check)


def tail_gradient(device, coeffs):
    """Through diag_fused: the card's gradient against the CPU's."""
    cols = [torch.as_tensor(x, device=device)
            for x in chip_smoke.tail_columns(517, L=61, seed=5)]

    def grads(dev):
        leaves = [x.detach().to(dev).requires_grad_() for x in cols]
        out = diag.diag_fused(*leaves)
        loss = chip_smoke.finite_sum(dict(zip(diag.DIAG_OUTPUTS, out)),
                                     diag.DIAG_OUTPUTS)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    return ((diag.diag_kernel,), lambda: grads(device), lambda: grads('cpu'),
            lambda got, want: chip_smoke.compare_grads('tail gradient', got,
                                                       want))


def neighbors_gradient(device, coeffs):
    """Through bridge_neighbors: the gradient equal to the twin's own
    autograd on the card, up to the order of float64 sums (the scans'
    backward scatters with atomics)."""
    p, valid = chip_smoke.neighbor_columns(301, 35, seed=9, device=device)
    p = p.nan_to_num(500.0, 1100.0, 1.0)
    w = torch.rand(2, *p.shape, generator=torch.Generator(
        device=device).manual_seed(3), device=device, dtype=p.dtype)

    def grad(fn):
        x = p.clone().requires_grad_()
        prev, nxt = fn(x, valid)
        loss = sum((torch.where(torch.isfinite(o), o, 0.0) * wi).sum()
                   for o, wi in zip((prev, nxt), w))
        return torch.autograd.grad(loss, x)

    def check(got, want):
        assert got[0].abs().sum() > 0
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)

    return ((parcels.bridge_neighbors_kernel,),
            lambda: grad(parcels.bridge_neighbors),
            lambda: grad(parcels._bridge_neighbors_twin), check)


def mix_gradient(device, coeffs):
    """Through the mixed-layer kernel: the gradient (the twin's VJP on the
    card) equal to the twin's own autograd there, up to the order of
    float64 sums (the neighbour scans' backward scatters with atomics)."""
    p, t, td = chip_smoke.mix_columns(301, 35, seed=9, device=device)
    depths = (100.0, 50.0)

    def grad(fn):
        xs = [x.clone().requires_grad_() for x in (p, t, td)]
        outs = fn(*xs, depths)
        loss = sum((torch.where(torch.isfinite(o), o, 0.0) * (k + 1)).sum()
                   for k, o in enumerate(outs))
        return torch.autograd.grad(loss, xs, allow_unused=True)

    def check(got, want):
        assert any(g is not None and g.nan_to_num().abs().sum() > 0
                   for g in got)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12,
                                           equal_nan=True)

    return ((parcels.mix_layers_kernel,),
            lambda: grad(parcels.mix_layers_kernel),
            lambda: grad(parcels._mix_layers_twin), check)


def most_unstable_gradient(device, coeffs):
    """Through the most-unstable kernel with a 1-D pressure that
    requires grad: outputs in the full shape, and every input's gradient
    (the twin's VJP on the card) equal to the twin's own autograd there,
    the pressure's in its (L,) shape, up to the order of the broadcast
    pressure's summed gradient."""
    p, t, td = (x[::chip_smoke.MU_KINDS] for x in chip_smoke.mu_columns(
        4800, 35, seed=9, device=device))

    def grad(fn):
        xs = [p[0].clone().requires_grad_(), t.clone().requires_grad_(),
              td.clone().requires_grad_()]
        outs = fn(*xs, 250.0)
        assert all(o.shape == t.shape for o in outs[:3])
        loss = sum((torch.where(torch.isfinite(o), o, 0.0) * (k + 1)).sum()
                   for k, o in enumerate(outs))
        return torch.autograd.grad(loss, xs, allow_unused=True)

    def check(got, want):
        assert got[0].shape == p[0].shape and got[0].abs().sum() > 0
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12,
                                       equal_nan=True)

    return ((parcels.most_unstable_kernel,),
            lambda: grad(parcels.most_unstable_kernel),
            lambda: grad(parcels._most_unstable_twin), check)


GRADIENTS = {'solve': solve_gradient, 'tail': tail_gradient,
             'neighbors': neighbors_gradient, 'mix': mix_gradient,
             'most_unstable': most_unstable_gradient}


@pytest.mark.parametrize('name', list(GRADIENTS))
def test_gradient_matches_twin(device, coeffs, name):
    """The seam's autograd.Function on the card: one launch of each kernel
    forward, and the gradient (the twin's VJP) held to the twin's."""
    kernels, on_card, reference, check = GRADIENTS[name](device, coeffs)
    before = [k.launches for k in kernels]
    got = on_card()
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    check(got, reference())


# --- the solve's options -----------------------------------------------------

@pytest.mark.parametrize('L', WIDTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_options_match_twin(device, coeffs, dtype, L):
    """Each option alone and all four together (the instance that reads the
    flags word), with and without the profile tracks, on the lane-edge
    columns: identical NaN patterns in float64 and chip_smoke.compare's
    bounds; the scalar outputs do not depend on the tracks being
    stored."""
    tables = AdiabatTables(coeffs.to(dtype))
    args = chip_smoke.lane_edge_args(301, tables, L=L, seed=L)
    name = str(dtype)[6:]
    for kw in chip_smoke.SOLVE_OPTIONS:
        got = fused.cape_cin_kernel(*args, **kw)
        got_p, prof = fused.cape_cin_kernel(*args, with_profile=True, **kw)
        torch.cuda.synchronize()
        want, want_prof = fused._column_outputs(*args, with_profile=True,
                                                **kw)
        assert torch.equal(got.nan_to_num(7.0), got_p.nan_to_num(7.0)), kw
        chip_smoke.compare(f'options {kw}', dict(zip(fused.OUTPUTS, got)),
                           dict(zip(fused.OUTPUTS, want)), name)
        chip_smoke.compare(f'options {kw} tracks',
                           dict(zip(fused.PROFILE, prof)),
                           dict(zip(fused.PROFILE, want_prof)), name)


def test_options_change_the_answer_and_count_launches(device, coeffs):
    tables = AdiabatTables(coeffs)
    p, t, td = (torch.as_tensor(x, device=device)
                for x in chip_smoke.hard_columns(301, L=40, seed=2))
    before = fused.cape_cin_kernel.launches
    base, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    real, _ = fused.fused_surface_cape_cin(
        p, t, td, tables=tables, virtual_temperature_correction=False)
    signed, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables,
                                             pos_cape_neg_cin=False)
    assert fused.cape_cin_kernel.launches == before + 3
    assert not torch.equal(base['cape'].nan_to_num(), real['cape'].nan_to_num())
    assert (signed['cape'].nan_to_num() <= base['cape'].nan_to_num() + 1e-9).all()
    with pytest.raises(TypeError):
        fused.fused_surface_cape_cin(p, t, td, tables=tables, no_such=1)
    with pytest.raises(ValueError):
        fused.fused_surface_cape_cin(p, t, td, tables=tables,
                                     lcl_interp='cubic')


def test_options_reach_the_gradient(device, coeffs):
    """The Function's backward runs the twin under the same options."""
    tables = AdiabatTables(coeffs)
    p, t, td = (torch.as_tensor(x, device=device)
                for x in chip_smoke.hard_columns(120, L=33, seed=4))
    kw = chip_smoke.SOLVE_OPTIONS[-1]

    def grad(dev, tab):
        tt = t.to(dev).clone().requires_grad_()
        res, _ = fused.fused_surface_cape_cin(p.to(dev), tt, td.to(dev),
                                              tables=tab, **kw)
        return torch.autograd.grad(
            chip_smoke.finite_sum(res, ('cape', 'cin')), tt)

    chip_smoke.compare_grads('options gradient', grad(device, tables),
                             grad('cpu', AdiabatTables(coeffs.cpu())),
                             skip=chip_smoke.repeated_level(p))


# --- streaming ---------------------------------------------------------------

def small_dataset(grid=(24, 40), L=30, seed=3):
    dat_np, td = chip_smoke.synthetic(grid[0] * grid[1], L=L, seed=seed)
    return chip_smoke.grid_dataset(dat_np, td, grid)


@pytest.mark.parametrize('chunk', [960, 333, 100, 5000],
                         ids=['one-chunk', 'ragged', 'many', 'larger'])
def test_streamed_dataset_call_matches_whole(device, coeffs, chunk):
    """A Dataset (level dim leading) through ``conv_properties_fused`` with
    the default device, whole and streamed through the pinned buffers and
    the side streams: every variable within the float32 budget (in
    practice bit-equal), attrs kept; several runs, so that a buffer
    reused too early would show."""
    tables = AdiabatTables(coeffs.float())
    ds = small_dataset()
    whole = xapi.conv_properties_fused(ds, tables=tables)
    for _ in range(3):
        got = xapi.conv_properties_fused(ds, tables=tables,
                                         stream_columns=chunk)
        assert set(got.data_vars) == set(whole.data_vars)
        chip_smoke.compare(
            'streamed',
            {k: torch.from_numpy(np.asarray(got[k].values))
             for k in whole.data_vars},
            {k: torch.from_numpy(np.asarray(whole[k].values))
             for k in whole.data_vars}, 'float32')
        assert all(got[k].attrs and got[k].dims == ('y', 'x')
                   for k in got.data_vars)


def test_stream_map_orders_its_streams(device):
    """Chunks whose compute is long against their copies, a prefetch of 1
    and of 3, and an output per chunk that depends on every input element:
    a copy that ran ahead of its consumer, or a block handed back early,
    would change a sum."""
    rng = np.random.default_rng(8)
    dat = {'pressure': rng.normal(size=(7001, 64)).astype(np.float32),
           'surface': rng.normal(size=(7001,)).astype(np.float32),
           'ids': rng.integers(0, 99, (7001,)).astype(np.int32)}

    def fn(d):
        x = d['pressure']
        for _ in range(40):
            x = torch.sin(x) + d['pressure']
        return {'s': x.sum(-1) + d['surface'], 'ids': d['ids'] + 1,
                'x': x}

    want = fn({k: torch.from_numpy(v).to(device) for k, v in dat.items()})
    for prefetch in (1, 3):
        got = stream_map(fn, dat, batch_columns=512, prefetch=prefetch)
        for k, v in want.items():
            assert np.array_equal(got[k], v.cpu().numpy()), (k, prefetch)
    assert got['ids'].dtype == np.int32 and got['x'].shape == (7001, 64)
    empty = stream_map(fn, {k: v[:0] for k, v in dat.items()})
    assert empty['x'].shape == (0, 64)


def test_default_device_is_the_card(device, coeffs):
    ds = small_dataset(grid=(4, 6), L=20)
    tables = AdiabatTables(coeffs.float())
    before = fused.cape_cin_kernel.launches, diag.diag_kernel.launches
    out = xapi.min_conv_properties_fused(ds, tables=tables)
    assert (fused.cape_cin_kernel.launches, diag.diag_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert isinstance(np.asarray(out['mixed_100_cape'].values), np.ndarray)
    sb = xapi.surface_based_cape_cin_dataset(ds, tables=tables,
                                             lcl_interp='linear',
                                             post_zero_cin=True)
    assert fused.cape_cin_kernel.launches == before[0] + 2
    assert (np.asarray(sb['cin'].values) <= 0).all()


# --- the mesh and deployment artifacts on the card ---------------------------

def pipeline_inputs(n, L=90, seed=0):
    dat, _ = chip_smoke.synthetic(n, L=L, seed=seed)
    return {k: np.ascontiguousarray(v) for k, v in dat.items()}


def test_two_way_mesh_on_one_card(device, coeffs):
    """``cuda:0`` twice: two shards run concurrently on the one card, each
    on its own host thread; every variable equals the single call's bit for
    bit and the launch counts are exact, twice (3, 1)."""
    from xarray_parcel_tpu_torch import parallel, pipeline
    tables = AdiabatTables(coeffs.float())
    mesh = parallel.make_mesh([device, device])
    assert mesh.local_devices() == [device]
    dat = pipeline_inputs(4099, seed=3)
    single = pipeline.conv_properties_fused(xapi.to_device(dat, device),
                                            tables=tables)
    padded, lead = parallel.pad_batch(dat, mesh)
    run = parallel.sharded_map(
        lambda d, tables: pipeline.conv_properties_fused(d, tables=tables),
        mesh)
    fused.cape_cin_kernel.launches = diag.diag_kernel.launches = 0
    out = run(padded, tables=parallel.replicate(tables, mesh))
    torch.cuda.synchronize()
    assert (fused.cape_cin_kernel.launches,
            diag.diag_kernel.launches) == (6, 2)
    for k, v in single.items():
        assert out[k].devices == {device} and len(out[k].shards) == 2
        np.testing.assert_array_equal(out[k].numpy()[:lead],
                                      v.cpu().numpy(), err_msg=k)
    streamed = stream_map(
        lambda d: pipeline.conv_properties_fused(d, tables=tables), dat,
        batch_columns=1024, mesh=mesh)
    for k, v in single.items():
        np.testing.assert_array_equal(streamed[k], v.cpu().numpy(),
                                      err_msg=k)
    with pytest.raises(ValueError, match='is not in the mesh'):
        stream_map(lambda d: d, dat, mesh=mesh, device='cpu')


def test_launch_counts_are_exact_from_many_threads(device, coeffs):
    """Eight entries on the one card launch the solve at once, many times:
    no launch is lost from the count."""
    from xarray_parcel_tpu_torch import parallel
    tables = AdiabatTables(coeffs.float())
    mesh = parallel.make_mesh([device] * 8)
    p, t, td = (np.ascontiguousarray(x)
                for x in chip_smoke.synthetic_columns(8 * 64))

    def many(p, t, td, tables):
        for _ in range(25):
            res, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables)
        return res['cape']

    fused.cape_cin_kernel.launches = 0
    out = parallel.sharded_map(many, mesh)(
        p, t, td, tables=parallel.replicate(tables, mesh))
    torch.cuda.synchronize()
    assert fused.cape_cin_kernel.launches == 8 * 25
    want, _ = fused.fused_surface_cape_cin(
        *(torch.from_numpy(x).to(device) for x in (p, t, td)), tables=tables)
    np.testing.assert_array_equal(out.numpy(), want['cape'].cpu().numpy())


def test_deployed_exact_fit_returns_cuda_tensors(device, coeffs, tmp_path):
    """An artifact exported beside the card carries the kernel library; an
    exact fit on device tensors stays on the card, host arrays of another
    size pad and chunk to the same values."""
    from xarray_parcel_tpu_torch import _build, deploy, pipeline
    tables = AdiabatTables(coeffs.float())
    path = tmp_path / 'fused.xpz'
    deploy.export_pipeline('min_conv_properties_fused', batch=2048,
                           tables=tables, path=path)
    loaded = deploy.load(path)
    assert loaded.meta['kernel_library'] and loaded.meta['platforms'] == [
        'cuda']
    with open(_build.library_path(), 'rb') as f:
        assert f.read() == loaded._library
    dat = pipeline_inputs(5000, seed=5)
    want = pipeline.min_conv_properties_fused(xapi.to_device(dat, device),
                                              tables=tables)
    fit = {k: torch.from_numpy(v[:2048]).to(device) for k, v in dat.items()}
    out = loaded(fit)
    for k, v in out.items():
        assert v.device == device
        assert torch.equal(v.nan_to_num(7.0), want[k][:2048].nan_to_num(7.0))
    served = loaded(dat)
    for k, v in want.items():
        assert isinstance(served[k], np.ndarray)
        np.testing.assert_array_equal(served[k], v.cpu().numpy(), err_msg=k)


# --- the JAX package's acceptance tiers through the kernels -----------------

@pytest.mark.parametrize('name', chip_smoke.TIER_GRIDS)
def test_tier_grid_through_the_kernels(device, coeffs, name):
    """Each tier grid in float64 through the kernel path on the card, with
    its launch counts: equal to the CPU twins and to the card's modular
    path, NaN and boolean patterns identical, values within 1e-10 of scale
    (``chip_smoke.F64_ATOL`` where only CUDA's exp/log rounding differs)."""
    outs, notes, launches = chip_smoke.hold_tier(name, AdiabatTables(coeffs),
                                                 device)
    assert outs and all(len(o) >= 6 for o in outs.values())
    assert launches in ((4, 2), (1, 0))
    for line in notes:
        print(line)


@pytest.mark.parametrize('kind', ['base', 'deep'])
def test_multicross_kernel_vs_serial(device, coeffs, kind):
    """The solve kernel on the multicross sets against the serial oracle:
    LFC/EL NaN together or within 1 hPa, CAPE/CIN within 1.5 J/kg."""
    outs, _, _ = chip_smoke.hold_tier(f'multicross/{kind}',
                                      AdiabatTables(coeffs), device)
    out = outs['fused_cape_cin']
    chip_smoke.check_multicross(kind, chip_smoke.multicross_set(kind)[1],
                                out['cape'], out['cin'], out['lfc_pressure'],
                                out['el_pressure'])
