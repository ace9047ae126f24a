"""End-to-end demo of the PyTorch/CUDA port: the demo notebook's flow as a
script.

The flow of ``examples/demo.py`` on ``xarray_parcel_tpu_torch``: the full
convection-diagnostics pipeline on a gridded batch of columns (the fused
one, whose CAPE/CIN solve and diagnostics tail run in the CUDA kernels on a
card and in their plain twins on the CPU), the storm proxies, the modular
pipeline on the exact-ODE moist lapse as the oracle, and throughput.

    python examples/demo_torch.py                      # on the GPU
    python examples/demo_torch.py --device cpu --grid 6

Without tables passed in, the coefficients are built on the device (a few
seconds on a card, minutes on a CPU).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def synthetic_dataset(n, L=60, seed=42):
    """A physically plausible (n, n, L) float64 grid of the pipeline's
    inputs, as ``examples/demo.py`` makes it."""
    rng = np.random.default_rng(seed)
    p = np.linspace(1009.0, 120.0, L)
    p = np.broadcast_to(p, (n, n, L)) + rng.normal(0, 0.4, (n, n, L))
    p = -np.sort(-p, axis=-1)
    t = 303.0 - 78.0 * (1.0 - (p / 1009.0) ** 0.3) + rng.normal(
        0, 1.8, (n, n, L))
    td = t - (np.abs(rng.normal(1.6, 1.6, (n, n, L))) + 0.2 +
              17.0 * (1.0 - p / 1009.0) ** 2)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    return {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (n, n)),
        'surface_wind_v': rng.normal(0, 2, (n, n)),
        'wind_u': rng.normal(8, 5, (n, n, L)),
        'wind_v': rng.normal(2, 5, (n, n, L)),
        'wind_height_above_surface': h - h[..., :1],
    }


def main(argv=None, tables=None):
    """Run the demo; ``tables``: adiabat tables to use instead of building
    the coefficients.  Returns the per-variable comparison reports."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--grid', type=int, default=15,
                    help='grid edge length (the reference demos on 15x15)')
    ap.add_argument('--device', default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from xarray_parcel_tpu_torch import adiabat, pipeline
    from xarray_parcel_tpu_torch._device import resolve_device
    from xarray_parcel_tpu_torch.utils import compare_results, time_function

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'CPU')
    print(f'device: {device} ({name})')
    if tables is None:
        tables, sec = time_function(adiabat.default_tables, device,
                                    torch.float64)
        print(f'adiabat coefficients built in {sec:.1f}s')
    tables = tables.astype(torch.float64).to(device)

    cols = args.grid * args.grid
    dat = {k: torch.as_tensor(v.reshape((cols,) + v.shape[2:]),
                              device=device)
           for k, v in synthetic_dataset(args.grid).items()}

    out, sec = time_function(pipeline.conv_properties_fused, dat,
                             tables=tables)
    out, sec = time_function(pipeline.conv_properties_fused, dat,
                             tables=tables)                # steady state
    print(f'\nconv_properties_fused: {len(out)} variables, {cols} columns '
          f'in {sec:.4f}s ({cols / sec:.0f} columns/sec)')
    for k in ('mu_cape', 'mu_cin', 'mixed_100_cape', 'mu_lifted_index',
              'freezing_level'):
        v = out[k].cpu().numpy()
        print(f'  {k:24s} mean={np.nanmean(v):9.2f} max={np.nanmax(v):9.2f}')

    proxies = pipeline.storm_proxies(out)
    active = {k: int(v.sum()) for k, v in proxies.items()
              if v.dtype == torch.bool}
    print(f'\nstorm proxies (active columns of {cols}): {active}')

    # The oracle: the modular pipeline on the exact-ODE moist lapse.
    ref, _ = time_function(pipeline.conv_properties, dat, tables=tables,
                           moist_lapse=adiabat.moist_lapse_integrate)
    print('\nfused pipeline vs modular pipeline on the exact-ODE oracle:')
    reports = compare_results(out, ref, tolerance=0.5)
    worst = max(reports, key=lambda r: r['max_abs_diff'])
    print(f'worst variable: {worst["name"]} '
          f'(max abs diff {worst["max_abs_diff"]:.3g})')
    return reports


if __name__ == '__main__':
    main()
