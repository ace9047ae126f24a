"""Device tensors in chunks: ``parallel.scan_map`` over
``pipeline.conv_properties_fused`` on an ensemble's columns already on the
card, more than it computes whole beside the other time step.

A time step holds every member: member m of time step s is the generator's
time step ``s * members + m``, written into one preallocated
(members * ny * nx, L) tensor a level variable and one (members * ny * nx,)
tensor a surface wind, member-major, so that a time step holds its fields
once, not twice.  Isobaric pressure is the (B, L) broadcast of its 1-D levels, as
``xarray_api`` hands it.  A call runs the pipeline in chunks of
``chunk_columns`` and is synchronised once, at its end.  Options:
``members`` and ``chunk_columns``; ``ignore_nans`` comes from the
configuration.  The work counts, the sampled outputs and inputs and the
layout check are ``entries/device.py``'s, over the whole call.
"""

import functools

import numpy as np
import torch

from parcelbench.data.columns import (LEVEL_VARS, SURFACE_VARS, TIME_STEPS,
                                      make_fields)
from parcelbench.entries.device import State as DeviceState, valid_levels
from xarray_parcel_tpu_torch import parallel, pipeline


def _ensemble(cfg, seed, step, members, device):
    """One time step's fields of every member, as (B, L) and (B,) tensors
    with B = members * ny * nx."""
    n = int(np.prod(cfg['grid']))
    out = {}
    for m in range(members):
        fields = make_fields(cfg, seed, step * members + m, device)
        for k in LEVEL_VARS + SURFACE_VARS:
            v = fields[k]
            if k == 'pressure' and v.dim() == 1:
                out.setdefault(k, v)            # one set of levels for all
                continue
            v = v.reshape(n, -1) if k in LEVEL_VARS else v.reshape(n)
            if k not in out:
                out[k] = torch.empty((members * n,) + v.shape[1:],
                                     dtype=v.dtype, device=v.device)
            out[k][m * n:(m + 1) * n] = v
        del fields
    B = members * n
    p = out['pressure']
    if p.dim() == 1:
        out['pressure'] = p.expand(B, p.shape[-1])
    return out


class State(DeviceState):
    def __init__(self, cell, seed, device, tables):
        cfg = cell.config
        self.cfg, self.tables = cfg, tables
        self.ignore_nans = bool(cfg['ignore_nans'])
        members = int(cell.options['members'])
        self.steps = [_ensemble(cfg, seed, s, members, device)
                      for s in range(TIME_STEPS)]
        self.columns = self.steps[0]['temperature'].shape[0]
        self.program = functools.partial(
            pipeline.conv_properties_fused, ignore_nans=self.ignore_nans,
            tables=tables)
        self.chunk_columns = int(cell.options['chunk_columns'])
        self.work = [{'columns': self.columns,
                      'levels': c['temperature'].shape[-1],
                      'valid_levels': valid_levels(c),
                      'itemsize': c['temperature'].element_size()}
                     for c in self.steps]

    def call(self, k):
        out = parallel.scan_map(self.program, self.steps[k],
                                self.chunk_columns)
        if self.steps[k]['temperature'].is_cuda:
            torch.cuda.synchronize()
        return out
