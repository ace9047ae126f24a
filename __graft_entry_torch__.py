"""Entry points of the PyTorch/CUDA port: a single-device forward step and a
multi-device dry run on a host mesh.

    python __graft_entry_torch__.py            # entry() once, on the GPU
    python __graft_entry_torch__.py dryrun 8   # the 8-way host-mesh dry run
"""

import numpy as np


def _synthetic_columns(batch_shape, L=90, dtype=np.float32, seed=0):
    """Synthetic but physically plausible soundings (pressure decreasing,
    warm moist surface, NaN-free)."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1008.0, 120.0, L, dtype=np.float64)
    t = 302.0 - 75.0 * (1.0 - (p / 1008.0) ** 0.28)
    t = np.broadcast_to(t, batch_shape + (L,)) + rng.normal(
        0.0, 1.5, batch_shape + (L,))
    td = t - np.abs(rng.normal(6.0, 4.0, batch_shape + (L,))) - 0.5
    p = np.broadcast_to(p, batch_shape + (L,))
    return (p.astype(dtype), t.astype(dtype), td.astype(dtype))


def entry(device=None, tables=None):
    """(fn, example_args): a forward step on the flagship path, the fused
    surface-based CAPE/CIN solve (the CUDA kernel on the GPU, its plain
    twin on ``device='cpu'``), and 256 example columns of 90 levels on
    ``device`` (None: the GPU).  ``tables``: the adiabat tables (None: the
    defaults, built on ``device`` when nothing is loaded)."""
    import torch

    from xarray_parcel_tpu_torch import adiabat, fused
    from xarray_parcel_tpu_torch._device import resolve_device

    device = resolve_device(device)
    if tables is None:
        tables = adiabat.default_tables(device, torch.float32)
    tables = tables.astype(torch.float32).to(device)

    def fn(pressure, temperature, dewpoint, tables):
        res, _ = fused.fused_surface_cape_cin(pressure, temperature,
                                              dewpoint, tables=tables)
        return res['cape'], res['cin']

    p, t, td = _synthetic_columns((256,), L=90)
    example_args = (*(torch.from_numpy(x).to(device) for x in (p, t, td)),
                    tables)
    return fn, example_args


def dryrun_multichip(n_devices: int, tables=None) -> None:
    """One full pipeline step over an ``n_devices``-way mesh on the host.

    Uses the real sharding layout: batch (columns) data-parallel over the
    mesh, level axis whole per entry, adiabat tables replicated, and the
    validation reduction of ``global_stats``.  The batch is uneven
    (``4 * n_devices + 3`` columns), so it goes pad -> shard -> compute ->
    slice.  Held to the single-device run on every variable, whole and
    streamed in sharded chunks: booleans and NaN patterns equal, float32
    values to rtol 2e-5 / atol 2e-4 (on the CPU a shard's shape picks
    other vector paths than the whole batch's, so the last bits differ).
    ``tables``: the adiabat tables (None: the defaults, built on the CPU
    when nothing is loaded, which takes minutes there).
    """
    import torch

    from xarray_parcel_tpu_torch import adiabat, pipeline, thermo
    from xarray_parcel_tpu_torch.parallel import (global_stats, make_mesh,
                                                  pad_batch, replicate,
                                                  sharded_map, stream_map)

    mesh = make_mesh(['cpu'] * n_devices)
    if tables is None:
        tables = adiabat.default_tables('cpu', torch.float32)
    tables = replicate(tables.astype(torch.float32).to('cpu'), mesh)

    B, L = 4 * n_devices + 3, 32
    p, t, td = _synthetic_columns((B,), L=L, seed=1)
    q = thermo.specific_humidity_from_dewpoint(
        torch.from_numpy(p), torch.from_numpy(td)).numpy()
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    rng = np.random.default_rng(2)
    dat = {
        'pressure': p, 'temperature': t,
        'specific_humidity': q.astype(np.float32),
        'height_asl': h.astype(np.float32),
        'surface_wind_u': rng.normal(3, 2, (B,)).astype(np.float32),
        'surface_wind_v': rng.normal(0, 2, (B,)).astype(np.float32),
        'wind_u': rng.normal(8, 5, (B, L)).astype(np.float32),
        'wind_v': rng.normal(2, 5, (B, L)).astype(np.float32),
        'wind_height_above_surface': (h - h[..., :1]).astype(np.float32),
    }

    def step(dat, tables):
        out = pipeline.conv_properties_fused(dat, tables=tables)
        out.update(pipeline.storm_proxies(out))
        return out

    dat_pad, B_orig = pad_batch(dat, mesh)
    assert B_orig == B
    out = {k: v.numpy()[:B]
           for k, v in sharded_map(step, mesh)(dat_pad,
                                               tables=tables).items()}

    # Correctness, not just liveness: the same step on one device must
    # agree with the n-way run on every variable, values and NaN pattern.
    out_1 = {k: v.numpy() for k, v in step(
        {k: torch.from_numpy(v) for k, v in dat.items()},
        tables.on('cpu')).items()}
    assert set(out) == set(out_1)

    def same(a, b, what):
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-4,
                                       equal_nan=True, err_msg=what)

    for k in out:
        assert out[k].size > 0, k
        same(out[k], out_1[k], f'sharded != single-device for {k!r}')

    # Out-of-core and data-parallel composed: the same grid streamed
    # through the mesh in sharded chunks (a chunk size the mesh does not
    # divide, so it rounds up and the tail chunk NaN-pads).
    streamed = stream_map(
        lambda d: pipeline.conv_properties_fused(d, tables=tables.on('cpu')),
        dat, batch_columns=2 * n_devices + 1, mesh=mesh)
    for k in streamed:
        same(streamed[k], out[k], f'streamed+sharded != sharded for {k!r}')

    # The validation reduction across the mesh against numpy's.
    cnt, mean, mx = global_stats(out['mu_cape'], mesh)
    fin = np.isfinite(out['mu_cape'])
    assert int(cnt) == int(fin.sum()), (cnt, fin.sum())
    if fin.any():
        np.testing.assert_allclose(
            float(mean), out['mu_cape'][fin].astype(np.float64).mean(),
            rtol=1e-12)
        assert float(mx) == float(out['mu_cape'][fin].max())
    print(f'dryrun_multichip OK: {n_devices} mesh entries on the host '
          f'(uneven B={B}), {len(out)} variables equal sharded-vs-single '
          f'(+{len(streamed)} streamed+sharded), '
          f'mu_cape mean={float(mean):.2f} max={float(mx):.2f} '
          f'over {int(cnt)} columns')


if __name__ == '__main__':
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == 'dryrun':
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        import torch
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print('entry OK:', [tuple(o.shape) for o in out])
