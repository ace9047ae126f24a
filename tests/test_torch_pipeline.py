"""The port's fused pipelines and storm proxies against the JAX package.

Holds the parcel preps and diagnostics to their JAX counterparts; the
pipelines -- ``conv_properties_fused`` and ``min_conv_properties_fused`` --
to JAX's (Pallas interpret mode; the full one with the lifted index from the
solve and, ``in_kernel_li=False``, from its profile tracks) at atol 1e-6 of
each output's scale, and the storm
proxies of each package's pipeline output to each other; and the port's
variables, storm proxies and reduced-pipeline (``min.*``) variables to the
committed regression archive at the archive test's own tolerance.  Also
checks that the port imports with JAX blocked.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import diagnostics as jdiag
from xarray_parcel_tpu import parcels as jparcels
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu_torch import AdiabatTables, thermo
from xarray_parcel_tpu_torch import diagnostics as tdiag
from xarray_parcel_tpu_torch import parcels as tparcels
from xarray_parcel_tpu_torch import pipeline as tpipeline

import chip_smoke
from make_regression_archive import ARCHIVE, make_inputs
from test_torch_ops import assert_same, columns, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'xarray_parcel_tpu_torch')
OUTPUTS = sorted([
    'mu_cape', 'mu_cin', 'mu_mixing_ratio', 'mixed_100_cape',
    'mixed_100_cin', 'mixed_50_cape', 'mixed_50_cin', 'mu_lifted_index',
    'mixed_100_lifted_index', 'mixed_50_lifted_index', 'mu_dci',
    'mixed_100_dci', 'mixed_50_dci', 'lapse_rate_700_500', 'temp_500',
    'freezing_level', 'melting_level', 'shear_u', 'shear_v',
    'shear_magnitude', 'positive_shear'])
MIN_OUTPUTS = sorted([
    'mixed_100_cape', 'mixed_100_cin', 'mixed_100_lifted_index',
    'lapse_rate_700_500', 'temp_500', 'freezing_level', 'melting_level',
    'shear_u', 'shear_v', 'shear_magnitude', 'positive_shear'])
PROXIES = sorted([
    'proxy_Craven2004', 'proxy_Kunz2007', 'proxy_Trapp2007',
    'proxy_Marsh2009', 'proxy_Allen2011', 'proxy_Allen2014',
    'proxy_Eccel2012', 'proxy_Mohr2013', 'ship', 'proxy_SHIP_0.1'])


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


def grid():
    """A 4 x 5 grid of 36-level columns with poisoned columns."""
    dat = make_inputs(ny=4, nx=5, L=36, seed=11)
    dat['specific_humidity'][2, 3, 7] = np.nan
    dat['pressure'][3, 1, -1] = np.nan
    return dat


def run_both(name, jax_tables, tables, **jax_kw):
    """JAX's (with ``jax_kw``) and the port's pipeline ``name`` on
    :func:`grid`."""
    dat = grid()
    want = getattr(jpipeline, name)(
        {k: jnp.asarray(v) for k, v in dat.items()}, tables=jax_tables,
        **jax_kw)
    got = getattr(tpipeline, name)(
        {k: to_torch(v) for k, v in dat.items()}, tables=tables)
    return {k: np.asarray(v) for k, v in want.items()}, got


def assert_pipeline_key(want, got, key):
    a, b = want[key], got[key]
    assert b.shape == (4, 5)
    scale = max(1.0, float(np.nanmax(np.abs(a)))) if a.dtype != bool else 1
    assert_same(a, b, atol=1e-6 * scale, rtol=0, name=key)


@pytest.fixture(scope='module')
def pipelines(jax_tables, tables):
    return run_both('conv_properties_fused', jax_tables, tables)


@pytest.fixture(scope='module')
def profile_li(jax_tables, tables):
    """The port's full pipeline against JAX's with the lifted index from
    the profile tracks: the two LI routes agree."""
    return run_both('conv_properties_fused', jax_tables, tables,
                    in_kernel_li=False)


@pytest.fixture(scope='module')
def reduced(jax_tables, tables):
    return run_both('min_conv_properties_fused', jax_tables, tables)


def test_pipeline_variable_set(pipelines, profile_li, reduced):
    for (want, got), keys in ((pipelines, OUTPUTS), (profile_li, OUTPUTS),
                              (reduced, MIN_OUTPUTS)):
        assert set(got) == set(want) == set(keys)


@pytest.mark.parametrize('key', OUTPUTS)
def test_pipeline_matches_jax(pipelines, key):
    assert_pipeline_key(*pipelines, key)


@pytest.mark.parametrize('key', OUTPUTS)
def test_profile_li_pipeline_matches_jax(profile_li, key):
    assert_pipeline_key(*profile_li, key)


@pytest.mark.parametrize('key', MIN_OUTPUTS)
def test_reduced_pipeline_matches_jax(reduced, key):
    assert_pipeline_key(*reduced, key)


def test_reduced_pipeline_has_no_valid_mask(reduced, pipelines):
    """The NaN-specific-humidity column (2, 3) keeps its shear and its
    temperature-only diagnostics, where the full pipeline masks them."""
    _, got = reduced
    _, full = pipelines
    assert torch.isfinite(got['shear_u'][2, 3])
    assert torch.isfinite(got['freezing_level'][2, 3])
    assert torch.isnan(full['shear_u'][2, 3])


@pytest.mark.parametrize('key', PROXIES)
def test_storm_proxies_of_the_pipeline_match_jax(pipelines, key):
    want, got = pipelines
    a = jpipeline.storm_proxies({k: jnp.asarray(v) for k, v in want.items()})
    b = tpipeline.storm_proxies(got)
    assert_same(np.asarray(a[key]), b[key], atol=1e-6, rtol=1e-9, name=key)


def test_off_mask_outputs(pipelines):
    _, got = pipelines
    for key in OUTPUTS:
        off = got[key][2, 3], got[key][3, 1]
        if got[key].dtype == torch.bool:
            assert not any(off), key
        else:
            assert all(torch.isnan(v) for v in off), key


@pytest.fixture(scope='module')
def archive(tables):
    with np.load(ARCHIVE) as f:
        inputs = {k[3:]: f[k] for k in f.files if k.startswith('in_')}
        expect = {k[4:]: f[k] for k in f.files if k.startswith('out_')}
    dat = {k: to_torch(v) for k, v in inputs.items()}
    got = tpipeline.conv_properties_fused(dat, tables=tables)
    got.update(tpipeline.storm_proxies(got))
    got.update({f'min.{k}': v for k, v in
                tpipeline.min_conv_properties_fused(dat,
                                                    tables=tables).items()})
    return expect, got


def test_regression_archive_variable_set(archive):
    expect, got = archive
    assert set(got) == set(expect)


@pytest.mark.parametrize('key', OUTPUTS + PROXIES +
                         [f'min.{k}' for k in MIN_OUTPUTS])
def test_regression_archive(archive, key):
    """The archive test's own bounds: identical NaN patterns, atol 1e-4 of
    the variable's scale, rtol 1e-6."""
    expect, got = archive
    a, b = got[key].numpy(), expect[key]
    if b.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=key)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
    scale = max(1.0, float(np.nanmax(np.abs(b))) * 1e-6)
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               atol=1e-4 * scale, rtol=1e-6, err_msg=key)


# --- parcel preps and diagnostics -----------------------------------------

def prep_columns():
    p, t, td = columns(B=10, L=20, seed=21)
    p[1, 4] = np.nan                  # interior NaN run to bridge
    t[2, 5:7] = np.nan
    p[3, -4:] = np.nan                # NaN top padding
    p[4, 1] = p[4, 0]                 # duplicate surface level
    t[5, :] = t[5, 0]                 # theta-e ties across levels
    td[5, :] = td[5, 0]
    p[6, :] = np.nan                  # all-NaN column
    return p, t, td


def both(jfn, tfn, *args, **kw):
    return (jfn(*(jnp.asarray(a) for a in args), **kw),
            tfn(*(to_torch(a) for a in args), **kw))


def test_bridge_neighbors():
    p, t, td = prep_columns()
    valid = ~(np.isnan(p) | np.isnan(t) | np.isnan(td))
    want, got = both(jparcels.bridge_neighbors, tparcels.bridge_neighbors,
                     p, valid)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize('layout', ['rows', 'broadcast', 'grid'])
def test_bridge_neighbors_takes_the_twin_on_the_cpu(layout):
    """CPU tensors take the plain twin, bit for bit, and launch nothing:
    the hard rows of chip_smoke.neighbor_columns, 1-D levels broadcast to
    the mask, a (ny, nx, L) batch."""
    p, valid = chip_smoke.neighbor_columns(96, 13, seed=1)
    if layout == 'broadcast':
        p = p[0]
    elif layout == 'grid':
        p, valid = p.reshape(8, 12, 13), valid.reshape(8, 12, 13)
    before = tparcels.bridge_neighbors_kernel.launches
    got = tparcels.bridge_neighbors(p, valid)
    assert tparcels.bridge_neighbors_kernel.launches == before
    assert got[0].shape == valid.shape
    chip_smoke.same_bits(layout, got,
                         tparcels._bridge_neighbors_twin(p, valid))


def neighbour_sums(fn, valid):
    """The finite parts of ``fn``'s (prev, next), for gradcheck (an
    infinite output has no finite difference)."""
    def sums(p):
        return tuple(torch.where(torch.isfinite(o), o, 0.0)
                     for o in fn(p, valid))
    return sums


def test_bridge_neighbors_gradient_on_the_cpu():
    """The gradient to pressure is torch's own through the twin on the
    CPU (gradcheck, float64), and ``bridge_neighbors``, through the seam's
    Function (forward the twin on a CPU tensor, backward its VJP), gives
    the same."""
    rng = np.random.default_rng(4)
    p = torch.tensor(rng.uniform(5.0, 1050.0, (6, 20)), requires_grad=True)
    valid = torch.tensor(rng.random((6, 20)) > 0.3)
    assert torch.autograd.gradcheck(
        neighbour_sums(tparcels._bridge_neighbors_twin, valid), (p,))
    assert torch.autograd.gradcheck(
        neighbour_sums(tparcels.bridge_neighbors, valid), (p,))
    w = torch.tensor(rng.random((2, 6, 20)))

    def grad(fn):
        outs = neighbour_sums(fn, valid)(p)
        return torch.autograd.grad(sum((o * wi).sum()
                                       for o, wi in zip(outs, w)), p)[0]

    want = grad(tparcels._bridge_neighbors_twin)
    assert want.abs().sum() > 0
    prev, _ = tparcels.bridge_neighbors(p, valid)
    assert prev.grad_fn.kernel is tparcels.bridge_neighbors_kernel
    assert torch.equal(grad(tparcels.bridge_neighbors), want)


def test_bridge_neighbors_kernel_rejects_off_the_card():
    """A mask on another device than the pressure, and the meta device,
    raise without a launch."""
    p, valid = chip_smoke.neighbor_columns(4, 5)
    before = tparcels.bridge_neighbors_kernel.launches
    with pytest.raises(TypeError):
        tparcels.bridge_neighbors_kernel(p, valid.to('meta'))
    with pytest.raises(TypeError):
        tparcels.bridge_neighbors_kernel(p.to('meta'), valid)
    with pytest.raises(ValueError):
        tparcels.bridge_neighbors_kernel(p.to('meta'), valid.to('meta'))
    assert tparcels.bridge_neighbors_kernel.launches == before


@pytest.mark.parametrize('layout', ['rows', 'broadcast', 'grid', '1-D'])
@pytest.mark.parametrize('depths', [(100.0,), (100.0, 50.0)])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_mix_layers_is_the_composition_on_the_cpu(dtype, depths, layout):
    """On CPU tensors ``mix_layers`` launches nothing and equals, bit for
    bit, what the fused pipelines composed before it: ``conserved_fields``,
    ``bridge_neighbors`` over the levels where p, t and td hold a number,
    then ``mix_layer(grow=False)`` at each depth; and ``mix_layer`` making
    its own (the reduced pipeline's former call).  On the hard rows of
    chip_smoke.mix_columns, with 1-D levels broadcast to the rows, on a
    (ny, nx, L) batch, and with the 1-D levels themselves, where every
    output takes the full shape and holds the composition's values
    broadcast."""
    p, t, td = chip_smoke.mix_columns(60, 24, seed=3, dtype=dtype)
    if layout == 'broadcast':
        p = p[0].expand_as(t)
    elif layout == '1-D':
        p = p[0]
    elif layout == 'grid':
        p, t, td = (x.reshape(4, 15, 24) for x in (p, t, td))
    before = tparcels.mix_layers_kernel.launches
    got = tparcels.mix_layers(p, t, td, depths)
    assert tparcels.mix_layers_kernel.launches == before
    cons = tparcels.conserved_fields(p, t, td)
    nbrs = tparcels.bridge_neighbors(p, ~(torch.isnan(p) | torch.isnan(t) |
                                          torch.isnan(td)))
    assert len(got) == len(depths)
    for (fields, parcel), depth in zip(got, depths):
        for want in (tparcels.mix_layer(p, t, td, depth=depth,
                                        conserved=cons, neighbors=nbrs,
                                        grow=False),
                     tparcels.mix_layer(p, t, td, depth=depth, grow=False)):
            for a, b in zip((fields, parcel), want):
                assert list(a) == list(b)
                assert all(v.shape == t.shape[:t.dim() - (a is parcel)]
                           for v in a.values())
                chip_smoke.same_bits(f'{layout} {depth}', list(a.values()),
                                     [w.expand_as(v) for v, w in
                                      zip(a.values(), b.values())])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_mix_layers_gradient_with_1d_pressure(dtype):
    """A 1-D pressure that requires grad: ``mix_layers`` takes the seam's
    Function on the CPU and gives every input the gradient of the twin's
    own autograd, bit for bit, the pressure's in its own (L,) shape.  On
    chip_smoke.mix_columns' plain soundings, under the first one's
    levels."""
    p, t, td = (x[::15] for x in chip_smoke.mix_columns(150, 24, seed=8,
                                                         dtype=dtype))
    depths = (100.0, 50.0)

    def grads(fn):
        xs = [p[0].clone().requires_grad_(), t.clone().requires_grad_(),
              td.clone().requires_grad_()]
        outs = fn(*xs, depths)
        loss = sum((torch.where(torch.isfinite(o), o, 0.0) * (k + 1)).sum()
                   for k, o in enumerate(outs))
        return outs, torch.autograd.grad(loss, xs, allow_unused=True)

    outs, got = grads(tparcels.mix_layers_kernel)
    assert outs[0].grad_fn.kernel is tparcels.mix_layers_kernel
    assert all(o.shape == t.shape for o in outs[0::6])
    twin_outs, want = grads(tparcels._mix_layers_twin)
    chip_smoke.same_bits('outputs', [o.detach() for o in outs],
                         [o.detach() for o in twin_outs])
    assert got[0].shape == p[0].shape
    assert got[0].abs().sum() > 0
    chip_smoke.same_bits('gradients', got, want)


def composed_most_unstable(p, t, td, depth):
    """``from_most_unstable_parcel`` as the pipelines composed it before
    the kernel: ``most_unstable_parcel``, then every level below the
    parcel NaN."""
    parcel = tparcels.most_unstable_parcel(p, t, td, depth=depth)
    keep = p <= parcel['pressure'][..., None]
    return (torch.where(keep, p, torch.nan), torch.where(keep, t, torch.nan),
            torch.where(keep, td, torch.nan), *parcel.values())


@pytest.mark.parametrize('layout', ['rows', 'broadcast', 'grid', '1-D'])
@pytest.mark.parametrize('depth', chip_smoke.MU_DEPTHS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_from_most_unstable_parcel_is_the_composition_on_the_cpu(
        dtype, depth, layout):
    """On CPU tensors ``from_most_unstable_parcel`` launches nothing and
    equals, bit for bit, ``most_unstable_parcel`` with the levels below
    the parcel masked, as the pipelines composed it before the kernel: on
    the hard rows of chip_smoke.mu_columns, with 1-D levels broadcast to
    the rows, on a (ny, nx, L) batch, and with the 1-D levels themselves,
    where every field takes the full shape."""
    p, t, td = chip_smoke.mu_columns(64, 24, seed=3, dtype=dtype)
    if layout == 'broadcast':
        p = p[0].expand_as(t)
    elif layout == '1-D':
        p = p[0]
    elif layout == 'grid':
        p, t, td = (x.reshape(4, 16, 24) for x in (p, t, td))
    before = tparcels.most_unstable_kernel.launches
    fields, parcel = tparcels.from_most_unstable_parcel(p, t, td, depth)
    assert tparcels.most_unstable_kernel.launches == before
    assert list(fields) == list(parcel) == ['pressure', 'temperature',
                                            'dewpoint']
    assert all(v.shape == t.shape for v in fields.values())
    assert all(v.shape == t.shape[:-1] for v in parcel.values())
    got = (*fields.values(), *parcel.values())
    chip_smoke.same_bits(f'{layout} {depth}', got,
                         composed_most_unstable(p, t, td, depth))
    chip_smoke.same_bits(f'{layout} {depth} twin', got,
                         tparcels._most_unstable_twin(p, t, td, depth))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_most_unstable_ties(dtype):
    """The twin's two tie rules on chip_smoke.mu_columns' tie rows: of two
    levels of one theta-e the first is the parcel, and of two levels
    equally far from the layer's bound the larger pressure bounds the
    layer (the smaller, the most unstable level, stays out)."""
    p, t, td = chip_smoke.mu_columns(160, 35, seed=5, dtype=dtype)
    kind = torch.arange(160) % chip_smoke.MU_KINDS
    tie = kind == 13
    e = thermo.equivalent_potential_temperature(p[:, :2], t[:, :2],
                                                td[:, :2])
    tie &= e[:, 0] == e[:, 1]
    assert int(tie.sum()) >= 8
    assert (t[tie, 0] != t[tie, 1]).all()
    out = tparcels._most_unstable_twin(p, t, td, 250.0)
    assert torch.equal(out[4][tie], t[tie, 0])
    for k, depth in zip((7, 8), chip_smoke.MU_DEPTHS):
        rows = torch.nonzero(kind == k)[:, 0]
        out = tparcels._most_unstable_twin(p, t, td, depth)
        bound = p[rows, 0] - depth
        hot = torch.argmax((p[rows] == (bound - 2.0)[:, None]).to(
            torch.uint8), -1)
        assert (p[rows, hot] == bound - 2.0).all()
        assert (out[3][rows] != p[rows, hot]).all()
        keep = tparcels.most_unstable_parcel(p[rows], t[rows], td[rows],
                                             depth=depth)
        assert torch.equal(keep['pressure'], out[3][rows])


def test_most_unstable_cape_cin_goes_through_the_kernel(monkeypatch):
    """The modular ``most_unstable_cape_cin`` makes its prep as
    ``from_most_unstable_parcel`` does, through the seam: one kernel call,
    and its parcel is that call's."""
    p, t, td = chip_smoke.mu_columns(32, 20, seed=2)
    calls = []

    def counted(*args):
        calls.append(args)
        return kernel(*args)

    kernel = tparcels.most_unstable_kernel
    monkeypatch.setattr(tparcels, 'most_unstable_kernel', counted)
    _, _, parcel = tparcels.most_unstable_cape_cin(p, t, td, depth=250.0)
    assert len(calls) == 1
    chip_smoke.same_bits('modular', tuple(parcel.values()),
                         tparcels._most_unstable_twin(p, t, td, 250.0)[3:])


@pytest.mark.parametrize('case', chip_smoke.MU_INPUTS[:-1])
def test_card_inputs_keep_the_twin_s_values(case):
    """``from_most_unstable_parcel``'s CUDA branch, with the twin in the
    kernel's place: inputs made what the kernel takes
    (``parcels._card_inputs``), outputs cast back to their inputs' dtypes,
    give each output of the twin on the inputs as they were, bit for bit,
    in its dtype and shape (half floats, whose theta-e the kernel makes in
    float32, only on the card)."""
    p, t, td, depth = chip_smoke.mu_inputs(case)
    want = tparcels._most_unstable_twin(p, t, td, depth)
    args = tparcels._card_inputs(p, t, td, depth)
    assert len({x.dtype for x in args[:3]}) == 1
    assert args[1].shape == args[2].shape == want[0].shape
    got = tparcels.most_unstable_kernel(*args)
    got = [o.to(w.dtype) for o, w in zip(got, want)]
    assert [o.shape for o in got] == [w.shape for w in want]
    chip_smoke.same_bits(case, got, want)


def test_column_kernels_take_one_level_or_more():
    """The card's column kernels refuse columns of no levels, where the
    twins raise too, rather than return an unwritten parcel."""
    p = torch.empty(3, 0)
    with pytest.raises(ValueError, match='one level'):
        tparcels._check_columns(p, p, p)
    for twin, extra in ((tparcels._most_unstable_twin, 250.0),
                        (tparcels._mix_layers_twin, (100.0,))):
        with pytest.raises(IndexError):
            twin(p, p, p, extra)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_most_unstable_gradient_with_1d_pressure(dtype):
    """A 1-D pressure that requires grad: ``from_most_unstable_parcel``
    takes the seam's Function on the CPU and gives every input the
    gradient of the twin's own autograd, bit for bit, the pressure's in its
    own (L,) shape.  On chip_smoke.mu_columns' plain soundings, under the
    first one's levels."""
    p, t, td = (x[::chip_smoke.MU_KINDS] for x in chip_smoke.mu_columns(
        160, 24, seed=8, dtype=dtype))

    def grads(fn):
        xs = [p[0].clone().requires_grad_(), t.clone().requires_grad_(),
              td.clone().requires_grad_()]
        outs = fn(*xs, 250.0)
        loss = sum((torch.where(torch.isfinite(o), o, 0.0) * (k + 1)).sum()
                   for k, o in enumerate(outs))
        return outs, torch.autograd.grad(loss, xs, allow_unused=True)

    outs, got = grads(tparcels.most_unstable_kernel)
    assert outs[0].grad_fn.kernel is tparcels.most_unstable_kernel
    assert all(o.shape == t.shape for o in outs[:3])
    twin_outs, want = grads(tparcels._most_unstable_twin)
    chip_smoke.same_bits('outputs', [o.detach() for o in outs],
                         [o.detach() for o in twin_outs])
    assert got[0].shape == p[0].shape
    assert got[0].abs().sum() > 0
    chip_smoke.same_bits('gradients', got, want)


@pytest.mark.parametrize('case', [
    ('1-D levels', (7,), None, (5, 7), 0, False),
    ('(1, L) row', (1, 7), None, (5, 7), 0, False),
    ('broadcast rows', (7,), 'expanded', (5, 7), 0, False),
    ('contiguous', (5, 7), None, (5, 7), 7, False),
    ('grid', (2, 5, 7), None, (2, 5, 7), 7, False),
    ('one row', (1, 7), None, (1, 7), 7, False),
    ('level stride 2', (5, 14), 'every other level', (5, 7), 7, True),
    ('column-major', (7, 5), 'transposed', (5, 7), 7, True),
    ('broadcast over x only', (2, 1, 7), None, (2, 5, 7), 7, True),
], ids=lambda c: c[0])
def test_kernel_rows_reads_what_it_can_in_place(case):
    """The layout the kernel takes: rows one row apart (stride 0) or L
    apart, in place where the pressure is laid out so, else a contiguous
    copy; the rows as the kernel addresses them are the broadcast
    pressure."""
    _, pshape, how, shape, want_stride, copies = case
    p = torch.arange(float(np.prod(pshape))).reshape(pshape)
    if how == 'expanded':
        p = p.expand(shape)
    elif how == 'every other level':
        p = p[..., ::2]
    elif how == 'transposed':
        p = p.t()
    rows, row_stride = tparcels._kernel_rows(p, torch.Size(shape))
    B, L = rows.shape
    assert (B * L, L, row_stride) == (int(np.prod(shape)), 7, want_stride)
    assert (rows.data_ptr() != p.data_ptr()) == copies
    read = torch.as_strided(rows, (B, L), (row_stride, 1))
    assert torch.equal(read, p.expand(shape).reshape(B, L))


def test_conserved_fields_and_mixed_layer():
    p, t, td = prep_columns()
    want, got = both(jparcels.conserved_fields, tparcels.conserved_fields,
                     p, t, td)
    assert_same(want, got)
    valid = ~(np.isnan(p) | np.isnan(t) | np.isnan(td))
    fields = {'pressure': p, **{k: np.asarray(v) for k, v in want.items()}}
    for depth in (50.0, 100.0):
        a = jparcels.mixed_layer({k: jnp.asarray(v)
                                  for k, v in fields.items()},
                                 depth=depth, valid=jnp.asarray(valid))
        b = tparcels.mixed_layer({k: to_torch(v) for k, v in fields.items()},
                                 depth, to_torch(valid))
        assert_same(a, b)


@pytest.mark.parametrize('depth', [50.0, 100.0])
def test_mixed_parcel_and_mix_layer(depth):
    p, t, td = prep_columns()
    assert_same(*both(jparcels.mixed_parcel, tparcels.mixed_parcel, p, t, td,
                      depth=depth))
    # Both the slot write (grow=False) and the splice (the default).
    for grow in (False, True):
        want = jparcels.mix_layer(*(jnp.asarray(a) for a in (p, t, td)),
                                  depth=depth, grow=grow)
        got = tparcels.mix_layer(*(to_torch(a) for a in (p, t, td)),
                                 depth=depth, grow=grow)
        assert got[0]['pressure'].shape[-1] == p.shape[-1] + grow
        assert_same(want, got)


def test_most_unstable_parcel():
    p, t, td = prep_columns()
    for depth in (250.0, 300.0):
        assert_same(*both(jparcels.most_unstable_parcel,
                          tparcels.most_unstable_parcel, p, t, td,
                          depth=depth))
        assert_same(*both(jparcels.from_most_unstable_parcel,
                          tparcels.from_most_unstable_parcel, p, t, td,
                          depth=depth))


def test_diagnostics():
    dat = make_inputs(ny=3, nx=4, L=30, seed=12)
    p, t, h = dat['pressure'], dat['temperature'], dat['height_asl']
    td = np.asarray(jpipeline.thermo.dewpoint_from_specific_humidity(
        p, t, dat['specific_humidity']))
    li = np.random.default_rng(3).normal(0, 3, (3, 4))
    assert_same(*both(jdiag.deep_convective_index,
                      tdiag.deep_convective_index, p, t, td, li))
    assert_same(*both(jdiag.lapse_rate, tdiag.lapse_rate, p, t, h,
                      with_isobars=True))
    assert_same(*both(jdiag.lapse_rate, tdiag.lapse_rate, p, t, h))
    assert_same(*both(jdiag.freezing_level_height,
                      tdiag.freezing_level_height, t, h))
    assert_same(*both(jdiag.melting_level_height, tdiag.melting_level_height,
                      p, t, td, h))
    assert_same(*both(jdiag.wind_shear, tdiag.wind_shear,
                      dat['surface_wind_u'], dat['surface_wind_v'],
                      dat['wind_u'], dat['wind_v'],
                      dat['wind_height_above_surface']))


# --- package boundary ---------------------------------------------------------

def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import xarray_parcel_tpu_torch as xt\n"
            "assert 'xarray_parcel_tpu' not in sys.modules\n"
            "print(xt.conv_properties_fused.__name__)\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'conv_properties_fused'


def test_port_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(r'^\s*(import|from)\s+(jax\b|xarray_parcel_tpu\b'
                         r'(?!_torch))', re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith('.py')]
    files.append(os.path.join(REPO, 'chip_smoke.py'))
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
