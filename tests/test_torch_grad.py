"""Gradients through the port: the modular path and the kernels' one
``autograd.Function`` (``_kernels.KernelCall``).

The analogues of ``tests/test_gradients.py`` (surface state, batched
Jacobian, parcel variants, the fused kernel, the full modular pipeline and
the NaN-parcel zero gradient), in float64 on the CPU: each port gradient is
held to ``jax.grad`` of the JAX package's function at rtol 1e-6 and to
central differences at that file's rtol.  On the CPU the kernels' wrappers
run their plain twins, and every kernel call routes through that Function
whenever a differentiable input requires grad, so these tests run its
backward (the twins' VJP).  The fused pipeline's gradient, through the
pre-pass, the solve and the tail, is held to the modular pipeline's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu import cape as jcape
from xarray_parcel_tpu import fused as jfused
from xarray_parcel_tpu import parcels as jparcels
from xarray_parcel_tpu import pipeline as jpipeline
from xarray_parcel_tpu import thermo as jthermo
from xarray_parcel_tpu_torch import AdiabatTables, _kernels
from xarray_parcel_tpu_torch import cape as tcape
from xarray_parcel_tpu_torch import diagnostics as tdiag
from xarray_parcel_tpu_torch import fused as tfused
from xarray_parcel_tpu_torch import parcels as tparcels
from xarray_parcel_tpu_torch import pipeline as tpipeline
from xarray_parcel_tpu_torch.lcl import lcl as tlcl

from make_regression_archive import make_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (REPO, os.path.join(REPO, 'benchmarks'))
                if p not in sys.path]

import chip_smoke  # noqa: E402
import diag_kernel_ab as jtail  # noqa: E402

JAX_RTOL = 1e-6
EPS = 1e-4


@pytest.fixture(scope='module')
def jax_tables():
    return jad.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def tables(jax_tables):
    return AdiabatTables.from_numpy(np.asarray(jax_tables.coeffs), 'cpu',
                                    torch.float64)


SOUNDING = (np.array([959., 779.2, 751.3, 724.3, 700., 269.]),
            np.array([22.2, 14.6, 12., 9.4, 7., -38.]) + 273.15,
            np.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15)


def jit_grad(fn, **kw):
    """``jax.grad`` of the JAX function, compiled once (far quicker on the
    CPU than differentiating op by op)."""
    return jax.jit(jax.grad(fn, **kw))


def in_graph(t, kernel):
    """Whether a node of the seam's Function that calls ``kernel`` is in
    the autograd graph of ``t``."""
    todo, seen = [t.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        if (type(node).__name__ == 'KernelCallBackward'
                and node.kernel is kernel):
            return True
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return False


def grad_of(fn, x):
    """d fn(x) / dx by torch autograd, for a float64 numpy ``x``."""
    x = torch.tensor(x, requires_grad=True)
    fn(x).backward()
    return x.grad.numpy()


def central(fn, x, i=None):
    """Central difference of the scalar ``fn`` at ``x`` (or at its element
    ``i``), step ``EPS``."""
    x = np.asarray(x, dtype=np.float64)
    up, down = x.copy(), x.copy()
    if i is None:
        up, down = x + EPS, x - EPS
    else:
        up[i] += EPS
        down[i] -= EPS
    return (float(fn(up)) - float(fn(down))) / (2 * EPS)


def with_value(x, i, v):
    """``x`` (tensor) with element ``i`` replaced by the tensor ``v``."""
    mask = torch.zeros(x.shape, dtype=torch.bool)
    mask[i] = True
    return torch.where(mask, v, x)


def test_grad_cape_wrt_surface_state(jax_tables, tables):
    levels, temps, dews = SOUNDING

    def port(t0, td0):
        res, _ = tcape.surface_based_cape_cin(
            torch.tensor(levels), with_value(torch.tensor(temps), 0, t0),
            with_value(torch.tensor(dews), 0, td0), tables=tables)
        return res['cape']

    def ref(t0, td0):
        res, _ = jcape.surface_based_cape_cin(
            jnp.asarray(levels), jnp.asarray(temps).at[0].set(t0),
            jnp.asarray(dews).at[0].set(td0), tables=jax_tables)
        return res['cape']

    t0 = torch.tensor(temps[0], requires_grad=True)
    td0 = torch.tensor(dews[0], requires_grad=True)
    port(t0, td0).backward()
    want = jit_grad(ref, argnums=(0, 1))(temps[0], dews[0])
    for got, w in zip((t0.grad, td0.grad), want):
        np.testing.assert_allclose(got.item(), float(w), rtol=JAX_RTOL)
    fd_t = central(lambda v: port(torch.tensor(v), torch.tensor(dews[0])),
                   temps[0])
    fd_td = central(lambda v: port(torch.tensor(temps[0]), torch.tensor(v)),
                    dews[0])
    np.testing.assert_allclose(t0.grad.item(), fd_t, rtol=1e-4)
    np.testing.assert_allclose(td0.grad.item(), fd_td, rtol=1e-4)


def test_grad_batched_jacobian(jax_tables, tables):
    levels, temps, dews = SOUNDING
    B = 4
    lv = np.broadcast_to(levels, (B, 6))
    tp = np.broadcast_to(temps, (B, 6)) + np.arange(B)[:, None] * 0.5
    dw = np.broadcast_to(dews, (B, 6))
    g = grad_of(lambda x: tcape.surface_based_cape_cin(
        torch.tensor(lv), x, torch.tensor(dw), tables=tables)[0]['cape']
        .sum(), tp)
    want = jit_grad(lambda x: jnp.sum(jcape.surface_based_cape_cin(
        jnp.asarray(lv), x, jnp.asarray(dw),
        tables=jax_tables)[0]['cape']))(jnp.asarray(tp))
    assert g.shape == tp.shape and np.isfinite(g).all()
    assert np.all(np.abs(g[:, 0]) > 0)
    np.testing.assert_allclose(g, np.asarray(want), rtol=JAX_RTOL,
                               atol=1e-9)


@pytest.mark.parametrize('fn', ['most_unstable_cape_cin',
                                'mixed_layer_cape_cin'])
def test_grad_through_parcel_variants(jax_tables, tables, fn):
    """Gradients survive the NaN-prefixed columns of the most-unstable
    subset and the mixed-layer splice."""
    levels, temps, dews = SOUNDING

    def port(t1):
        res, _, _ = getattr(tparcels, fn)(
            torch.tensor(levels), with_value(torch.tensor(temps), 1, t1),
            torch.tensor(dews), tables=tables)
        return res['cape']

    def ref(t1):
        res, _, _ = getattr(jparcels, fn)(
            jnp.asarray(levels), jnp.asarray(temps).at[1].set(t1),
            jnp.asarray(dews), tables=jax_tables)
        return res['cape']

    g = grad_of(port, temps[1])
    assert np.isfinite(g)
    np.testing.assert_allclose(g, float(jit_grad(ref)(temps[1])),
                               rtol=JAX_RTOL)
    np.testing.assert_allclose(
        g, central(lambda v: port(torch.tensor(v)), temps[1]), rtol=1e-3)


@pytest.mark.parametrize('output', ['cape', 'cin', 'lifted_index'])
def test_grad_through_fused_kernel(jax_tables, tables, output):
    """The solve's Function: its backward is the twin's VJP, as the JAX
    package's custom_vjp."""
    levels, temps, dews = SOUNDING
    lv, dw = levels[None], dews[None]

    def port(t0):
        tp = with_value(torch.tensor(temps[None]), (0, 0), t0)
        res, _ = tfused.fused_surface_cape_cin(
            torch.tensor(lv), tp, torch.tensor(dw), tables=tables,
            with_lifted_index=True)
        return res[output][0]

    def ref(t0):
        res, _ = jfused.fused_surface_cape_cin(
            jnp.asarray(lv), jnp.asarray(temps[None]).at[0, 0].set(t0),
            jnp.asarray(dw), tables=jax_tables, block_columns=8,
            with_lifted_index=True)
        return res[output][0]

    t0 = torch.tensor(temps[0], requires_grad=True)
    out = port(t0)
    assert in_graph(out, tfused.cape_cin_kernel)
    out.backward()
    g = t0.grad.item()
    assert np.isfinite(g) and g != 0.0
    np.testing.assert_allclose(g, float(jit_grad(ref)(temps[0])),
                               rtol=JAX_RTOL)
    np.testing.assert_allclose(
        g, central(lambda v: port(torch.tensor(v)), temps[0]), rtol=1e-4)


def test_solve_function_with_profile_and_all_inputs(tables):
    """Every float input of the solve gets the twin's gradient, with the
    profile tracks as outputs too; the inference path has no graph."""
    p, t, td = (torch.tensor(x) for x in chip_smoke.hard_columns(24, L=20,
                                                                 seed=2))
    args = list(tfused.prepass(p, p[:, 0], t[:, 0], td[:, 0], tables))
    row, scalars, k0 = args
    floats = [x.clone().requires_grad_() for x in (p, t, td, row, scalars)]
    out, prof = tfused.cape_cin_kernel(*floats, k0, True)
    assert in_graph(out, tfused.cape_cin_kernel)
    w = torch.linspace(0.5, 1.5, out.numel()).reshape(out.shape)
    wp = torch.linspace(-1.0, 1.0, prof.numel()).reshape(prof.shape)
    loss = ((torch.nan_to_num(out) * w).sum() +
            (torch.nan_to_num(prof) * wp).sum())
    got = torch.autograd.grad(loss, floats, allow_unused=True)
    plain = [x.clone().requires_grad_() for x in (p, t, td, row, scalars)]
    out2, prof2 = tfused._column_outputs(*plain, k0, with_profile=True)
    loss2 = ((torch.nan_to_num(out2) * w).sum() +
             (torch.nan_to_num(prof2) * wp).sum())
    want = torch.autograd.grad(loss2, plain, allow_unused=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)
    assert tfused.cape_cin_kernel(p, t, td, row, scalars, k0).grad_fn is None
    res, _ = tfused.fused_surface_cape_cin(p, t, td, tables=tables)
    assert res['cape'].grad_fn is None


def prepass_loss(row, scalars):
    """A weighted sum of the pre-pass's float outputs, NaN entries
    dropped."""
    w = torch.linspace(0.5, 1.5, row.shape[-1], dtype=row.dtype)
    ws = torch.linspace(-1.0, 2.0, scalars.shape[-1], dtype=row.dtype)
    return ((torch.nan_to_num(row) * w).sum() +
            (torch.nan_to_num(scalars) * ws).sum())


def test_prepass_function_gradient_is_the_twins(tables):
    """The pre-pass Function's gradient to the parcel's pressure,
    temperature and dewpoint equals autograd through the plain pre-pass,
    on columns with NaN parcels and parcels outside the adiabat family."""
    p, t, td = (torch.tensor(x) for x in chip_smoke.hard_columns(40, L=20,
                                                                 seed=4))

    def grads(fn):
        leaves = [x[:, 0].clone().requires_grad_() for x in (p, t, td)]
        row, scalars, _ = fn(p, *leaves, tables)
        return torch.autograd.grad(prepass_loss(row, scalars), leaves)

    got = grads(tfused.prepass_kernel)
    want = grads(tfused._prepass_twin)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)
    assert all((g.nan_to_num() != 0).any() for g in got)


def test_prepass_function_gradcheck(tables):
    """float64 gradcheck of the pre-pass Function's rows and scalars
    against the parcel state, on valid parcels inside the family."""
    p, t, td = (torch.tensor(x) for x in chip_smoke.hard_columns(40, L=20,
                                                                 seed=4))
    keep = torch.isfinite(p).all(-1) & torch.isfinite(t).all(-1) & \
        torch.isfinite(td).all(-1) & (t[:, 0] < 310.0)
    p, t, td = (x[keep][:3] for x in (p, t, td))
    state = tuple(x[:, 0].clone().requires_grad_() for x in (p, t, td))
    assert torch.autograd.gradcheck(
        lambda *x: tfused.prepass_kernel(p, *x, tables)[:2], state)


def test_surface_parcel_gradient_unchanged(tables):
    """``fused_surface_cape_cin``'s gradients, with the pre-pass behind its
    Function, equal those of autograd through the plain pre-pass into
    the solve's Function."""
    p, t, td = (torch.tensor(x) for x in chip_smoke.hard_columns(40, L=20,
                                                                 seed=9))

    def grads(fused_path):
        leaves = [x.clone().requires_grad_() for x in (p, t, td)]
        if fused_path:
            res, sol = tfused.fused_surface_cape_cin(
                *leaves, tables=tables, with_lifted_index=True)
            out = {**res, **sol}
        else:
            lp, lt, ltd = leaves
            args = tfused._prepass_twin(lp, lp[:, 0], lt[:, 0], ltd[:, 0],
                                        tables)
            block = tfused.cape_cin_kernel(*leaves, *args[:2], args[2],
                                           False)
            out = dict(zip(tfused.OUTPUTS, block))
        assert in_graph(out['cape'], tfused.prepass_kernel) == fused_path
        assert in_graph(out['cape'], tfused.cape_cin_kernel)
        loss = chip_smoke.finite_sum(out, ('cape', 'cin', 'lifted_index',
                                           'lfc_pressure', 'el_pressure'))
        return torch.autograd.grad(loss, leaves)

    got, want = grads(True), grads(False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, equal_nan=True, rtol=1e-12,
                                   atol=1e-12 * b.nan_to_num().abs().max())
    assert (got[1][:, 0].nan_to_num() != 0).any()


def test_grad_through_tail_kernel():
    """The tail's Function against ``jax.grad`` of the JAX package's
    ``_diag_body`` on the hard tail columns."""
    cols = chip_smoke.tail_columns(40, L=30, seed=13)
    w = np.random.default_rng(1).uniform(0.5, 1.5, (6, 40))

    def port(t):
        p, td, h = (torch.tensor(x) for x in (cols[0], cols[2], cols[3]))
        out = torch.stack(tdiag.diag_fused(p, t, td, h))
        assert in_graph(out, tdiag.diag_kernel) == t.requires_grad
        return (torch.nan_to_num(out) * torch.tensor(w)).sum()

    def ref(t):
        out = jnp.stack(jtail._diag_body(jnp.asarray(cols[0]), t,
                                         jnp.asarray(cols[2]),
                                         jnp.asarray(cols[3])))
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * w)

    g = grad_of(port, cols[1])
    want = np.asarray(jit_grad(ref)(jnp.asarray(cols[1])))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(want),
                               rtol=JAX_RTOL, atol=1e-12)
    i = np.unravel_index(np.argmax(np.abs(np.nan_to_num(g))), g.shape)
    assert g[i] != 0.0
    np.testing.assert_allclose(
        g[i], central(lambda v: port(torch.tensor(v)), cols[1], i),
        rtol=1e-4)


def pipeline_input(t1):
    """The golden sounding as one pipeline column, level 1 set to ``t1``
    (a tensor)."""
    levels, temps, dews = SOUNDING
    q = np.asarray(jthermo.specific_humidity_from_dewpoint(levels, dews))
    h = 44330.0 * (1.0 - (levels / 1013.25) ** 0.19)
    return {
        'pressure': torch.tensor(levels[None]),
        'temperature': with_value(torch.tensor(temps), 1, t1)[None],
        'specific_humidity': torch.tensor(q[None]),
        'height_asl': torch.tensor(h[None]),
        'surface_wind_u': torch.tensor([3.0]),
        'surface_wind_v': torch.tensor([0.0]),
        'wind_u': torch.full((1, 6), 8.0, dtype=torch.float64),
        'wind_v': torch.full((1, 6), 2.0, dtype=torch.float64),
        'wind_height_above_surface': torch.tensor((h - h[0])[None]),
    }


def test_grad_through_full_pipeline(jax_tables, tables):
    levels, temps, dews = SOUNDING

    def port(t1):
        out = tpipeline.conv_properties(pipeline_input(t1), tables=tables)
        return out['mu_cape'][0]

    def ref(t1):
        q = jthermo.specific_humidity_from_dewpoint(levels, dews)
        h = 44330.0 * (1.0 - (levels / 1013.25) ** 0.19)
        dat = {'pressure': jnp.asarray(levels[None]),
               'temperature': jnp.asarray(temps).at[1].set(t1)[None],
               'specific_humidity': jnp.asarray(q)[None],
               'height_asl': jnp.asarray(h[None]),
               'surface_wind_u': jnp.array([3.0]),
               'surface_wind_v': jnp.array([0.0]),
               'wind_u': jnp.full((1, 6), 8.0),
               'wind_v': jnp.full((1, 6), 2.0),
               'wind_height_above_surface': jnp.asarray((h - h[0])[None])}
        return jpipeline.conv_properties(dat, tables=jax_tables)[
            'mu_cape'][0]

    g = grad_of(port, temps[1])
    assert np.isfinite(g)
    np.testing.assert_allclose(g, float(jit_grad(ref)(temps[1])),
                               rtol=JAX_RTOL)
    np.testing.assert_allclose(
        g, central(lambda v: port(torch.tensor(v)), temps[1]), rtol=1e-3)


def test_lcl_nan_parcel_zero_gradient():
    """The fixed point iterates on safe dummies: a NaN parcel's cotangent
    is exactly zero, never 0 * NaN."""
    def total(t):
        out = tlcl(torch.full_like(t, 1000.0), t, t - 5.0)
        lp = out['lcl_pressure']
        return torch.where(torch.isnan(lp), 0.0, lp).sum()

    g = grad_of(total, np.array([300.0, np.nan, 295.0]))
    assert np.isfinite(g[[0, 2]]).all() and g[1] == 0.0, g


def scalar_loss(out):
    """A weighted sum of every float output (NaN entries dropped)."""
    loss = 0.0
    for i, k in enumerate(sorted(out)):
        v = out[k]
        if v.dtype != torch.bool:
            loss = loss + (i + 1) * torch.where(torch.isfinite(v), v,
                                                0.0).sum()
    return loss


@pytest.mark.parametrize('name', ['conv_properties', 'min_conv_properties'])
def test_fused_pipeline_gradient_matches_modular(tables, name):
    """The fused pipeline's gradient (both Functions on its path) against
    the modular pipeline's, with respect to temperature and specific
    humidity, on NaN-free columns."""
    dat = make_inputs(ny=2, nx=3, L=24, seed=5)
    t = dat['temperature']
    t[0, 0, 5] = 0.5 * (t[0, 0, 4] + t[0, 0, 6])  # the archive's NaN, undone
    grads = {}
    for path in (name, name + '_fused'):
        x = {k: torch.tensor(v) for k, v in dat.items()}
        for k in ('temperature', 'specific_humidity'):
            x[k].requires_grad_()
        out = getattr(tpipeline, path)(x, tables=tables)
        scalar_loss(out).backward()
        grads[path] = [x[k].grad.numpy()
                       for k in ('temperature', 'specific_humidity')]
    for a, b in zip(grads[name + '_fused'], grads[name]):
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-9 * np.abs(b).max())


def test_fused_pipeline_runs_both_functions(tables):
    dat = make_inputs(ny=2, nx=1, L=20, seed=6)
    dat['temperature'][0, 0, 5] = dat['temperature'][0, 0, 4] - 1.0
    x = {k: torch.tensor(v) for k, v in dat.items()}
    x['temperature'].requires_grad_()
    seen = set()
    forward = _kernels.KernelCall.forward

    def spy(ctx, kernel, *args):
        seen.add(kernel.what)
        return forward(ctx, kernel, *args)

    try:
        _kernels.KernelCall.forward = staticmethod(spy)
        out = tpipeline.conv_properties_fused(x, tables=tables)
    finally:
        _kernels.KernelCall.forward = staticmethod(forward)
    assert seen == {'pre-pass', 'CAPE/CIN', 'diagnostics-tail',
                    'mixed-layer', 'most-unstable'}
    scalar_loss(out).backward()
    assert torch.isfinite(x['temperature'].grad).all()
