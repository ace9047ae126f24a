"""Dataset-surface demo of the PyTorch/CUDA port: the per-function notebook
flow on Datasets.

The flow of ``examples/xarray_demo.py`` on
``xarray_parcel_tpu_torch.xarray_api``: per-function calls (lcl, the parcel
profile, lfc_el, the three CAPE variants, diagnostics) on DataArrays, then
the one-call pipeline and storm proxies, whole and streamed in column
chunks.  Host Datasets in and out; the work runs on ``--device``.  Works
with real xarray when installed, else with the port's ``xr_lite``.

    python examples/xarray_demo_torch.py                # on the GPU
    python examples/xarray_demo_torch.py --device cpu --grid 4
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
    """Run the demo; ``tables``: adiabat tables to use instead of building
    the coefficients.  Returns the pipeline's Dataset."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--grid', type=int, default=8)
    ap.add_argument('--device', default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    import xarray_parcel_tpu_torch.xarray_api as parcel
    from xarray_parcel_tpu_torch import adiabat, thermo
    from xarray_parcel_tpu_torch._device import resolve_device

    xr = parcel.xr
    if xr.__name__.endswith('xr_lite'):
        print('(xarray not installed; using the port\'s xr_lite)')
    device = resolve_device(args.device)
    if tables is None:
        tables = adiabat.default_tables(device, torch.float64)
    kw = dict(tables=tables, device=device)

    n = args.grid
    raw = synthetic_dataset(n)
    dims3 = ('latitude', 'longitude', 'model_level_number')
    dat = xr.Dataset(
        {k: ((dims3 if np.ndim(v) == 3 else dims3[:2]), v)
         for k, v in raw.items()},
        coords={'latitude': np.arange(n) * 0.1,
                'longitude': np.arange(n) * 0.1})
    print(f'grid: {n}x{n} columns x {dict(dat.dims)["model_level_number"]} '
          f'levels on {device}')

    # --- the per-function flow ---
    dew = thermo.dewpoint_from_specific_humidity(
        *(torch.as_tensor(np.asarray(dat[k].values))
          for k in ('pressure', 'temperature', 'specific_humidity')))
    dat['dewpoint'] = (dims3, dew.numpy())

    def sfc(name):
        da = dat[name]
        axis = da.dims.index('model_level_number')
        return xr.DataArray(np.asarray(da.values).take(0, axis=axis),
                            dims=tuple(d for d in da.dims
                                       if d != 'model_level_number'))

    lcls = parcel.lcl(sfc('pressure'), sfc('temperature'), sfc('dewpoint'),
                      device=device)
    print('lcl_pressure mean:',
          float(np.nanmean(np.asarray(lcls['lcl_pressure'].values))))

    prof = parcel.parcel_profile_with_lcl(
        dat['pressure'], dat['temperature'], dat['dewpoint'],
        sfc('pressure'), sfc('temperature'), sfc('dewpoint'), **kw)
    print('profile levels:', np.asarray(prof['temperature'].values).shape[-1])

    sol = parcel.lfc_el(prof['pressure'], prof['virtual_temperature'],
                        prof['environment_virtual_temperature'],
                        prof['lcl_pressure'],
                        prof['lcl_virtual_temperature'], device=device)
    print('columns with an LFC:',
          int(np.isfinite(np.asarray(sol['lfc_pressure'].values)).sum()),
          '/', n * n)

    columns = (dat['pressure'], dat['temperature'], dat['dewpoint'])
    res, _ = parcel.surface_based_cape_cin(*columns, **kw)
    mu, _, _ = parcel.most_unstable_cape_cin(*columns, depth=250.0,
                                             prefix='mu', **kw)
    ml, _, _ = parcel.mixed_layer_cape_cin(*columns, depth=100.0, **kw)
    print('surface/mu/mixed-100 CAPE means:',
          [round(float(np.nanmean(np.asarray(x.values))), 1)
           for x in (res['cape'], mu['mu_cape'], ml['cape'])])

    li = parcel.lifted_index(prof, device=device)
    wb = parcel.wet_bulb_temperature_fast(dat['temperature'],
                                          dat['dewpoint'], device=device)
    shear = parcel.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                              dat['wind_u'], dat['wind_v'],
                              dat['wind_height_above_surface'],
                              device=device)
    print('LI mean:',
          round(float(np.nanmean(np.asarray(li['lifted_index'].values))), 2),
          ' fast-wet-bulb mean:',
          round(float(np.nanmean(np.asarray(wb.values))), 1),
          ' shear mean:', round(float(np.nanmean(
              np.asarray(shear['shear_magnitude'].values))), 1))

    # --- the one-call pipeline and the proxies ---
    out = parcel.conv_properties_fused(dat, **kw)
    proxies = parcel.storm_proxies(out, device=device)
    print('pipeline variables:', len(out.data_vars),
          ' proxies:', len(proxies.data_vars))
    print('mu_cape attrs:', out['mu_cape'].attrs)

    # --- streamed in column chunks: the same answers ---
    streamed = parcel.conv_properties_fused(
        dat, stream_columns=max(4, n * n // 4), **kw)
    diff = float(np.nanmax(np.abs(np.asarray(streamed['mu_cape'].values) -
                                  np.asarray(out['mu_cape'].values))))
    print('streamed vs whole max |d mu_cape|:', diff)
    assert diff < 1e-3
    return out


if __name__ == '__main__':
    main()
