"""The CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and ``nvcc``: the kernels have no CPU mode.
Without a card they skip.  Where JAX is not installed, run them without
the JAX-configuring ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

import chip_smoke
from xarray_parcel_tpu_torch import AdiabatTables, adiabat, fused
from xarray_parcel_tpu_torch import diagnostics as diag

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel runs only on the card')
    return torch.device('cuda', 0)


@pytest.fixture(scope='module')
def coeffs(device):
    return adiabat.build_spectral(device)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_kernel_matches_twin(device, coeffs, dtype):
    """Identical NaN patterns; float64 within 1e-6, float32 within the
    float32 budget (chip_smoke.compare)."""
    tables = AdiabatTables(coeffs.to(dtype))
    cols = [torch.as_tensor(x, dtype=dtype, device=device)
            for x in chip_smoke.hard_columns(301, L=57, seed=3)]
    args = chip_smoke.kernel_args(*cols, tables)
    got = fused.cape_cin_kernel(*args)
    torch.cuda.synchronize()
    want = fused._column_outputs(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    chip_smoke.compare('kernel', dict(zip(fused.OUTPUTS, got)),
                       dict(zip(fused.OUTPUTS, want)), str(dtype)[6:])


def test_launch_counter_and_empty_batch(device, coeffs):
    tables = AdiabatTables(coeffs)
    p, t, td = (torch.as_tensor(x, device=device)
                for x in chip_smoke.hard_columns(40))
    before = fused.cape_cin_kernel.launches
    res, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    assert fused.cape_cin_kernel.launches == before + 1
    assert res['cape'].device == p.device
    res, _ = fused.fused_surface_cape_cin(p[:0], t[:0], td[:0],
                                          tables=tables)
    assert res['cape'].shape == (0,)
    assert fused.cape_cin_kernel.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(device, coeffs):
    tables = AdiabatTables(coeffs)
    p, t, td = (torch.as_tensor(x, device=device)
                for x in chip_smoke.hard_columns(20))
    row, scalars, k0 = fused.prepass(p, p[:, 0], t[:, 0], td[:, 0], tables)
    with pytest.raises(TypeError):
        fused.cape_cin_kernel(p.float(), t, td, row, scalars, k0)
    with pytest.raises(TypeError):
        fused.cape_cin_kernel(p, t, td, row, scalars, k0.long())
    with pytest.raises(ValueError):
        fused.cape_cin_kernel(p, t[:, :-1], td, row, scalars, k0)
    with pytest.raises(ValueError):
        fused.cape_cin_kernel(p, t, td, row[:, :40], scalars, k0)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_profile_tracks_match_twin(device, coeffs, dtype):
    """The solve's profile tracks against the twin's, and the lifted index
    interpolated from them against the in-kernel one."""
    tables = AdiabatTables(coeffs.to(dtype))
    cols = [torch.as_tensor(x, dtype=dtype, device=device)
            for x in chip_smoke.hard_columns(301, L=57, seed=3)]
    args = chip_smoke.kernel_args(*cols, tables)
    out, prof = fused.cape_cin_kernel(*args, with_profile=True)
    torch.cuda.synchronize()
    assert prof.shape == (3, args[0].shape[0], 58)
    assert torch.equal(out.nan_to_num(7.0),
                       fused.cape_cin_kernel(*args).nan_to_num(7.0))
    _, want = fused._column_outputs(*args, with_profile=True)
    assert torch.equal(torch.isnan(prof), torch.isnan(want))
    name = str(dtype)[6:]
    chip_smoke.compare('profile', dict(zip(fused.PROFILE, prof)),
                       dict(zip(fused.PROFILE, want)), name)
    li = diag.lifted_index(dict(zip(fused.PROFILE, prof)))['lifted_index']
    chip_smoke.compare('profile LI', li, out[-1], name)


def test_solve_gradient_matches_twin(device, coeffs):
    """The solve's autograd.Function on the card: one launch forward, and
    the gradient (the twin's VJP on the card) equal to the CPU's."""
    tables = AdiabatTables(coeffs)
    cols, parcel = chip_smoke.variant_columns(*(
        torch.as_tensor(x, device=device)
        for x in chip_smoke.hard_columns(301, L=57, seed=3)))

    def grads(dev, tab):
        leaves = [x.detach().to(dev).requires_grad_()
                  for x in (*cols.values(), *parcel.values())]
        res, _ = fused.fused_cape_cin(
            *leaves[:3], parcel_pressure=leaves[3],
            parcel_temperature=leaves[4], parcel_dewpoint=leaves[5],
            tables=tab, with_lifted_index=True)
        loss = chip_smoke.finite_sum(res, ('cape', 'cin', 'lifted_index'))
        return torch.autograd.grad(loss, leaves)

    before = fused.cape_cin_kernel.launches
    got = grads(device, tables)
    assert fused.cape_cin_kernel.launches == before + 1
    want = grads('cpu', AdiabatTables(coeffs.cpu()))
    chip_smoke.compare_grads(
        'solve gradient', got, want,
        skip=chip_smoke.repeated_level(cols['pressure']))


def test_tail_gradient_matches_twin(device):
    cols = [torch.as_tensor(x, device=device)
            for x in chip_smoke.tail_columns(517, L=61, seed=5)]

    def grads(dev):
        leaves = [x.detach().to(dev).requires_grad_() for x in cols]
        out = diag.diag_fused(*leaves)
        loss = chip_smoke.finite_sum(dict(zip(diag.DIAG_OUTPUTS, out)),
                                     diag.DIAG_OUTPUTS)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    before = diag.diag_kernel.launches
    got = grads(device)
    assert diag.diag_kernel.launches == before + 1
    want = grads('cpu')
    chip_smoke.compare_grads('tail gradient', got, want)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_tail_kernel_matches_twin(device, dtype):
    cols = [torch.as_tensor(x, dtype=dtype, device=device)
            for x in chip_smoke.tail_columns(517, L=61, seed=5)]
    got = diag.diag_kernel(*cols)
    torch.cuda.synchronize()
    want = torch.stack(diag._diag_body(*cols))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    chip_smoke.compare('tail', dict(zip(diag.DIAG_OUTPUTS, got)),
                       dict(zip(diag.DIAG_OUTPUTS, want)), str(dtype)[6:])


def test_tail_launch_counter_and_empty_batch(device):
    p, t, td, h = (torch.as_tensor(x, device=device)
                   for x in chip_smoke.tail_columns(40, L=30))
    before = diag.diag_kernel.launches
    out = diag.diag_fused(p.reshape(4, 10, -1), t.reshape(4, 10, -1),
                          td.reshape(4, 10, -1), h.reshape(4, 10, -1))
    assert diag.diag_kernel.launches == before + 1
    assert len(out) == 6 and out[0].shape == (4, 10)
    assert out[0].device == p.device
    out = diag.diag_kernel(p[:0], t[:0], td[:0], h[:0])
    assert out.shape == (6, 0)
    assert diag.diag_kernel.launches == before + 1


def test_tail_wrapper_rejects_what_the_kernel_does_not_take(device):
    p, t, td, h = (torch.as_tensor(x, device=device)
                   for x in chip_smoke.tail_columns(20, L=30))
    with pytest.raises(TypeError):
        diag.diag_kernel(p.float(), t, td, h)
    with pytest.raises(TypeError):
        diag.diag_kernel(p.half(), t.half(), td.half(), h.half())
    with pytest.raises(ValueError):
        diag.diag_kernel(p, t[:, :-1], td, h)
    with pytest.raises(ValueError):
        diag.diag_kernel(p[0], t[0], td[0], h[0])
