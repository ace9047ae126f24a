"""Multi-device example of the PyTorch/CUDA port: the full pipeline sharded
over a device mesh.

Columns are independent, so the only parallel decision is the batch
sharding: each mesh entry runs the pipeline on its shard (its own host
thread and device), the adiabat tables are replicated, and the only
communication is the validation reduction of ``global_stats``.  On cards
the mesh is every CUDA device of the process (``parallel.make_mesh()``);
with ``--device cpu`` it is a host mesh of ``--entries`` CPU entries.

    python examples/multichip_torch.py                   # every card
    python examples/multichip_torch.py --device cpu --entries 8 --grid 6

Several processes: ``torchrun --nproc-per-node=N`` with
``parallel.distributed_init()`` called first in each.
"""

import argparse
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from demo_torch import synthetic_dataset  # noqa: E402  (the shared grid)


def main(argv=None, tables=None):
    """Run the example; ``tables``: adiabat tables to use instead of
    building the coefficients.  Returns the sharded run's outputs."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--grid', type=int, default=16)
    ap.add_argument('--device', default=None,
                    help="'cuda' (the default: every card) or 'cpu'")
    ap.add_argument('--entries', type=int, default=8,
                    help='mesh entries on the host with --device cpu')
    args = ap.parse_args(argv)

    import torch

    from xarray_parcel_tpu_torch import adiabat, parallel, pipeline
    from xarray_parcel_tpu_torch._device import resolve_device

    device = resolve_device(args.device)
    mesh = (parallel.make_mesh(['cpu'] * args.entries)
            if device.type == 'cpu' else parallel.make_mesh())
    print(f'mesh: {mesh.devices.size} x {device.type}')
    if tables is None:
        tables = adiabat.default_tables(device, torch.float32)
    tables = parallel.replicate(tables.astype(torch.float32).to(device),
                                mesh)

    def step(dat, tables):
        return pipeline.conv_properties(dat, tables=tables)

    host = {k: v.reshape((-1,) + v.shape[2:]).astype(np.float32)
            for k, v in synthetic_dataset(args.grid, L=40).items()}
    padded, n = parallel.pad_batch(host, mesh)
    out = {k: v.numpy()[:n] for k, v in parallel.sharded_map(step, mesh)(
        padded, tables=tables).items()}

    # The workload's only communication: cross-device validation stats.
    cnt, mean, mx = parallel.global_stats(out['mu_cape'], mesh)
    print(f'mu_cape over {int(cnt)} columns: mean={float(mean):.1f} '
          f'max={float(mx):.1f} J/kg')

    # Out-of-core and data-parallel composed: grids larger than one
    # device's memory stream through the mesh in sharded chunks.
    streamed = parallel.stream_map(
        lambda d: pipeline.conv_properties(d, tables=tables.on(
            d['pressure'].device)), host, batch_columns=64, mesh=mesh)
    np.testing.assert_allclose(streamed['mu_cape'], out['mu_cape'],
                               rtol=1e-5, atol=1e-4, equal_nan=True)
    print(f'streamed+sharded: {len(streamed)} variables match the '
          f'whole-grid sharded run')
    return out


if __name__ == '__main__':
    main()
