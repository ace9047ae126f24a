"""One process of a two-process run of the PyTorch port on a global mesh.

Launched by ``test_torch_mesh.py``, twice: each process holds four entries
on its host (``['cpu'] * 4``) and joins an 8-entry global mesh through
``parallel.distributed_init`` (gloo).  The process

* builds the global mesh (``make_mesh``, which gathers both ranks' lists),
* shards the host-replicated input grid over it, so that it places only
  its own entries' shards, and runs the full modular pipeline on them,
* holds its own output shards to the matching slices of the single-process
  result the parent computed (1e-6 of each output's scale; the poisoned
  column NaN), and ``global_stats``, an all-reduce across both ranks, to
  the parent's host-side reduction,
* streams a toy program over the mesh and gets the whole result back,
* serves an uneven batch through a mesh artifact, whose chunk outputs span
  both processes and are gathered by ``Deployed._host``.

Usage: distributed_worker_torch.py <rank> <processes> <port> <npz>
"""

import sys

import numpy as np
import torch


def scaled(a, b, name):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                  err_msg=f'NaN pattern: {name}')
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=name)
        return
    scale = max(1.0, float(np.nanmax(np.abs(b), initial=0.0)))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0,
                               atol=1e-6 * scale, err_msg=name)


def main():
    rank, nproc, port, data_path = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    from xarray_parcel_tpu_torch import AdiabatTables, deploy, pipeline
    from xarray_parcel_tpu_torch.parallel import (distributed_init,
                                                  global_stats, make_mesh,
                                                  replicate, sharded_map,
                                                  stream_map)

    distributed_init(f'127.0.0.1:{port}', nproc, rank)
    mesh = make_mesh(['cpu'] * 4)
    assert mesh.size == 4 * nproc and mesh.processes == nproc
    assert mesh.rank == rank and len(mesh.entries()) == 4
    print(f'[worker {rank}] 4 local / {mesh.size} global entries', flush=True)

    with np.load(data_path) as f:
        dat = {k[3:]: f[k] for k in f.files if k.startswith('in_')}
        expect = {k[4:]: f[k] for k in f.files if k.startswith('out_')}
        minref = {k[7:]: f[k] for k in f.files if k.startswith('minout_')}
        tables = AdiabatTables(torch.from_numpy(f['coeffs']))

    out = sharded_map(
        lambda d, tables: pipeline.conv_properties(d, tables=tables), mesh)(
        dat, tables=replicate(tables, mesh))
    checked = 0
    for k, ref in expect.items():
        arr = out[k]
        assert arr.shape == ref.shape and len(arr.shards) == 4
        for key, shard in arr.shards.items():
            assert 4 * rank <= key[0] < 4 * (rank + 1), (rank, key)
            scaled(shard.numpy(), ref[arr._slices(key)], f'{k} shard {key}')
            checked += 1
    assert checked > 0
    # Each process gets the whole array, gathered.
    scaled(out['mu_cape'].numpy(), expect['mu_cape'], 'gathered mu_cape')

    cnt, mean, mx = global_stats(out['mu_cape'], mesh)
    ref = expect['mu_cape']
    fin = np.isfinite(ref)
    assert int(cnt) == int(fin.sum()), (cnt, fin.sum())
    np.testing.assert_allclose(float(mean), float(ref[fin].mean()),
                               rtol=1e-9)
    np.testing.assert_allclose(float(mx), float(ref[fin].max()), rtol=1e-9)

    streamed = stream_map(
        lambda d: {'top': d['pressure'][:, -1] * 2.0}, dat,
        batch_columns=10, level_vars=('pressure',), mesh=mesh)
    np.testing.assert_array_equal(streamed['top'],
                                  dat['pressure'][:, -1] * 2.0)
    print(f'[worker {rank}] OK: {checked} shards verified, '
          f'all-reduced count={int(cnt)}', flush=True)

    # B=24 through an exported batch of 16: padded to 32, two sharded
    # chunks; every process ends with the full value.
    dep = deploy.export_pipeline('min_conv_properties', batch=16,
                                 levels=dat['pressure'].shape[1],
                                 dtype=np.float64, tables=tables, mesh=mesh)
    served = dep(dat, mesh=mesh)
    for k, ref in minref.items():
        assert isinstance(served[k], np.ndarray) and \
            served[k].shape == ref.shape, k
        scaled(served[k], ref, k)
    print(f'[worker {rank}] serving OK: {len(minref)} variables, '
          f'batch {dat["pressure"].shape[0]} through exported 16',
          flush=True)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
