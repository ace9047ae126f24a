"""Host Dataset: ``xarray_api.conv_properties_fused`` on a Dataset in host
memory, as a post-processing job calls it, host Dataset out.

Every level variable is (level, y, x) with the level dim leading, as model
output is; isobaric pressure is a 1-D variable over the level dim; the
surface winds are (y, x); latitude and longitude are coordinates.
Options: ``stream_columns`` (chunks through ``parallel.stream_map``);
``ignore_nans`` comes from the configuration.
"""

import numpy as np
import torch

from parcelbench.data.columns import (LEVEL_VARS, SURFACE_VARS, TIME_STEPS,
                                      make_fields)
from parcelbench.reference.pipeline import OUTPUTS
from xarray_parcel_tpu_torch import xarray_api


def _host(x):
    return x.cpu().numpy()


def _dataset(fields, cfg):
    """The fields as a host Dataset laid out as the configuration states,
    and the count of levels with finite pressure, temperature and
    humidity."""
    vert = cfg['vert_dim']
    dims = tuple(cfg['batch_dims'])
    p = fields['pressure']
    t, q = fields['temperature'], fields['specific_humidity']
    valid = int((torch.isfinite(p) & torch.isfinite(t)
                 & torch.isfinite(q)).sum())
    data = {}
    for k in LEVEL_VARS:
        v = fields[k]
        data[k] = (((vert,), _host(v)) if v.dim() == 1 else
                   ((vert,) + dims, _host(v.permute(2, 0, 1).contiguous())))
    for k in SURFACE_VARS:
        data[k] = (dims, _host(fields[k]))
    ny, nx = cfg['grid']
    coords = {dims[0]: np.linspace(*cfg['latitude'], ny),
              dims[1]: np.linspace(*cfg['longitude'], nx)}
    return xarray_api.xr.Dataset(data, coords=coords), valid


class State:
    def __init__(self, cell, seed, device, tables):
        cfg = cell.config
        self.cfg, self.tables, self.device = cfg, tables, device
        self.ignore_nans = bool(cfg['ignore_nans'])
        self.stream_columns = cell.options.get('stream_columns')
        made = [_dataset(make_fields(cfg, seed, s, device), cfg)
                for s in range(TIME_STEPS)]
        self.steps = [ds for ds, _ in made]
        self.grid = tuple(cfg['grid'])
        self.columns = int(np.prod(self.grid))
        L = self.steps[0]['temperature'].shape[0]
        self.work = [{'columns': self.columns, 'levels': L,
                      'valid_levels': valid, 'itemsize': 4}
                     for _, valid in made]

    def call(self, k):
        return xarray_api.conv_properties_fused(
            self.steps[k], vert_dim=self.cfg['vert_dim'],
            tables=self.tables, ignore_nans=self.ignore_nans,
            stream_columns=self.stream_columns, device=self.device)

    def _at(self, idx):
        return np.unravel_index(np.asarray(idx), self.grid)

    def sample_outputs(self, out, idx):
        iy, ix = self._at(idx)
        return {k: np.asarray(out[k].values)[iy, ix] for k in OUTPUTS
                if k in out.data_vars}

    def layout_faults(self, out):
        """Variables missing or extra, or not float32 (positive_shear:
        bool) arrays over the input's batch dims with its coordinates."""
        names = set(out.data_vars)
        faults = len(names ^ set(OUTPUTS))
        dims = tuple(self.cfg['batch_dims'])
        given = self.steps[0].coords
        for k in names & set(OUTPUTS):
            v = out[k]
            want = np.bool_ if k == 'positive_shear' else np.float32
            arr = np.asarray(v.values)
            faults += int(tuple(v.dims) != dims or arr.shape != self.grid
                          or arr.dtype != want)
        for d in dims:
            faults += int(d not in out.coords or not np.array_equal(
                np.asarray(out.coords[d].values),
                np.asarray(given[d].values)))
        return faults

    def sample_inputs(self, k, idx):
        iy, ix = self._at(idx)
        ds = self.steps[k]
        n = len(iy)
        out = {}
        for name in LEVEL_VARS:
            a = np.asarray(ds[name].values)
            cols = (np.broadcast_to(a, (n,) + a.shape) if a.ndim == 1
                    else a[:, iy, ix].T)
            out[name] = torch.from_numpy(np.ascontiguousarray(cols))
        for name in SURFACE_VARS:
            out[name] = torch.from_numpy(np.asarray(ds[name].values)[iy, ix])
        return {name: v.to(self.device) for name, v in out.items()}

    def close(self):
        self.steps = None
