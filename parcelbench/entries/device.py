"""Device tensors: ``pipeline.conv_properties_fused`` on (B, L) columns
already on the card, as a caller whose fields live there makes the call.

Each level variable is a contiguous (B, L) tensor.  Isobaric pressure is
handed as the (B, L) broadcast of its 1-D levels, as ``xarray_api`` hands
it.  Each call is synchronised, as a caller reading its outputs would be.
Options: ``ignore_nans`` comes from the configuration.
"""

import numpy as np
import torch

from parcelbench.data.columns import (LEVEL_VARS, SURFACE_VARS, TIME_STEPS,
                                      make_fields)
from parcelbench.reference.pipeline import OUTPUTS
from xarray_parcel_tpu_torch import pipeline


def _columns(fields, cfg):
    B = int(np.prod(cfg['grid']))
    out = {}
    for k in LEVEL_VARS:
        v = fields[k]
        out[k] = (v.expand(B, v.shape[-1]) if v.dim() == 1
                  else v.reshape(B, v.shape[-1]))
    for k in SURFACE_VARS:
        out[k] = fields[k].reshape(B)
    return out


def valid_levels(cols):
    """Levels with finite pressure, temperature and humidity."""
    ok = (torch.isfinite(cols['pressure']) & torch.isfinite(
        cols['temperature']) & torch.isfinite(cols['specific_humidity']))
    return int(ok.sum())


class State:
    def __init__(self, cell, seed, device, tables):
        cfg = cell.config
        self.cfg, self.tables = cfg, tables
        self.ignore_nans = bool(cfg['ignore_nans'])
        self.steps = [_columns(make_fields(cfg, seed, s, device), cfg)
                      for s in range(TIME_STEPS)]
        self.columns = self.steps[0]['temperature'].shape[0]
        self.work = [{'columns': self.columns,
                      'levels': c['temperature'].shape[-1],
                      'valid_levels': valid_levels(c),
                      'itemsize': c['temperature'].element_size()}
                     for c in self.steps]

    def call(self, k):
        out = pipeline.conv_properties_fused(
            self.steps[k], ignore_nans=self.ignore_nans, tables=self.tables)
        if self.steps[k]['temperature'].is_cuda:
            torch.cuda.synchronize()
        return out

    def sample_outputs(self, out, idx):
        idx = torch.as_tensor(idx, device=out['mu_cape'].device)
        return {k: out[k][idx].cpu().numpy() for k in OUTPUTS if k in out}

    def layout_faults(self, out):
        """Outputs missing or extra, or not (B,) float32 (positive_shear:
        bool) tensors on the inputs' device."""
        faults = len(set(out) ^ set(OUTPUTS))
        device = self.steps[0]['temperature'].device
        for k in set(out) & set(OUTPUTS):
            want = torch.bool if k == 'positive_shear' else torch.float32
            v = out[k]
            faults += int(v.shape != (self.columns,) or v.dtype != want
                          or v.device != device)
        return faults

    def sample_inputs(self, k, idx):
        idx = torch.as_tensor(idx, device=self.steps[k]['temperature'].device)
        return {name: v[idx] for name, v in self.steps[k].items()}

    def close(self):
        self.steps = None
