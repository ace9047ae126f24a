"""The seam every hand-written kernel is called through (``_kernels``), on
the CPU, once for each of the six kernels.

A CPU tensor runs the kernel's plain twin and counts no launch; the meta
device, which has no kernel, raises; an input the kernel declares
differentiable that requires grad sends the call through the one
``autograd.Function``, whose gradient equals autograd's through the twin
bit for bit.
"""

import numpy as np
import pytest
import torch

from xarray_parcel_tpu import adiabat as jad
from xarray_parcel_tpu_torch import AdiabatTables
from xarray_parcel_tpu_torch import diagnostics as tdiag
from xarray_parcel_tpu_torch import fused as tfused
from xarray_parcel_tpu_torch import parcels as tparcels

import chip_smoke


@pytest.fixture(scope='module')
def tables():
    return AdiabatTables.from_numpy(
        np.asarray(jad.load_moist_adiabat_lookups().coeffs), 'cpu',
        torch.float64)


def solve_args(tables, dtype):
    p, t, td = (torch.as_tensor(x, dtype=dtype)
                for x in chip_smoke.hard_columns(24, L=20, seed=2))
    tab = tables.astype(dtype)
    return (p, t, td, *tfused.prepass(p, p[:, 0], t[:, 0], td[:, 0], tab))


def prepass_args(tables, dtype):
    return (*chip_smoke.prepass_args(30, L=20, dtype=dtype),
            tables.astype(dtype))


def tail_args(tables, dtype):
    return tuple(torch.as_tensor(x, dtype=dtype)
                 for x in chip_smoke.tail_columns(30, L=24, seed=13))


def neighbors_args(tables, dtype):
    p, valid = chip_smoke.neighbor_columns(16, 20, seed=4, dtype=dtype)
    return p.nan_to_num(500.0, 1100.0, 1.0), valid


def mix_args(tables, dtype):
    return (*chip_smoke.mix_columns(30, 20, seed=6, dtype=dtype),
            (100.0, 50.0))


def mu_args(tables, dtype):
    return (*chip_smoke.mu_columns(32, 20, seed=6, dtype=dtype), 250.0)


KERNELS = {
    'solve': (tfused.cape_cin_kernel, solve_args),
    'prepass': (tfused.prepass_kernel, prepass_args),
    'tail': (tdiag.diag_kernel, tail_args),
    'neighbors': (tparcels.bridge_neighbors_kernel, neighbors_args),
    'mix': (tparcels.mix_layers_kernel, mix_args),
    'most_unstable': (tparcels.most_unstable_kernel, mu_args),
}


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


def loss(out):
    """A weighted sum of the float outputs' finite entries."""
    total = 0.0
    for o in outputs(out):
        if o.is_floating_point():
            w = torch.linspace(0.5, 1.5, o.numel(),
                               dtype=o.dtype).reshape(o.shape)
            total = total + (torch.where(torch.isfinite(o), o, 0.0) * w).sum()
    return total


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('name', list(KERNELS))
def test_kernel_call_on_the_cpu(tables, name, dtype):
    kernel, make = KERNELS[name]
    args = make(tables, dtype)
    before = kernel.launches
    got, want = kernel(*args), kernel.twin(*args)
    assert kernel.launches == before
    assert all(g.grad_fn is None for g in outputs(got))
    for a, b in zip(outputs(got), outputs(want)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)

    meta = [x.to('meta') if torch.is_tensor(x) else x for x in args]
    with pytest.raises(ValueError, match=f'no {kernel.what} kernel'):
        kernel(*meta)

    def grads(fn):
        leaves = [x.clone().requires_grad_() if i in kernel.differentiable
                  else x for i, x in enumerate(args)]
        out = fn(*leaves)
        return out, torch.autograd.grad(
            loss(out), [leaves[i] for i in kernel.differentiable],
            allow_unused=True)

    out, got = grads(kernel)
    assert outputs(out)[0].grad_fn.kernel is kernel
    _, want = grads(kernel.twin)
    assert any(g is not None and (g.nan_to_num() != 0).any() for g in got)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)
    assert kernel.launches == before


@pytest.mark.parametrize('name', list(KERNELS))
def test_kernel_call_by_keyword(tables, name):
    """Arguments given by keyword bind to the twin's parameters: the same
    outputs as the positional call, the one Function when a differentiable
    input requires grad, and a tensor on another device rejected."""
    kernel, make = KERNELS[name]
    args = make(tables, torch.float64)
    names = list(kernel.signature.parameters)[:len(args)]
    for a, b in zip(outputs(kernel(**dict(zip(names, args)))),
                    outputs(kernel(*args))):
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)

    def grads(call):
        leaves = [x.clone().requires_grad_() if i in kernel.differentiable
                  else x for i, x in enumerate(args)]
        out = call(leaves)
        assert outputs(out)[0].grad_fn.kernel is kernel
        return torch.autograd.grad(
            loss(out), [leaves[i] for i in kernel.differentiable],
            allow_unused=True)

    got = grads(lambda xs: kernel(**dict(zip(names, xs))))
    for a, b in zip(got, grads(lambda xs: kernel(*xs))):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)

    last = max(i for i, x in enumerate(args) if torch.is_tensor(x))
    with pytest.raises(TypeError, match='share a device'):
        kernel(*args[:last], **{names[last]: args[last].to('meta')},
               **dict(zip(names[last + 1:], args[last + 1:])))
