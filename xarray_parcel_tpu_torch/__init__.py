"""PyTorch/CUDA port of xarray_parcel_tpu's fused convection diagnostics.

Plain torch functions on tensors with the level axis last: the fused
pipelines (``conv_properties_fused``, ``min_conv_properties_fused``), the
storm proxies and SHIP, and the fused CAPE/CIN solve.  On the GPU the
per-column CAPE/CIN solve and the pipelines' diagnostics tail run in
hand-written CUDA kernels (``csrc/fused_cape.cu``, ``csrc/diag_tail.cu``,
built at first use by ``_build.py``); on the CPU in their plain torch
twins.  Imports torch and numpy only.
"""

from . import adiabat, cape, constants, diagnostics, fused, lcl, ops
from . import parcels, pipeline, thermo
from .adiabat import AdiabatTables
from .fused import fused_cape_cin, fused_surface_cape_cin
from .pipeline import (conv_properties_fused, min_conv_properties_fused,
                       storm_proxies)

__all__ = ['adiabat', 'cape', 'constants', 'diagnostics', 'fused', 'lcl',
           'ops', 'parcels', 'pipeline', 'thermo', 'AdiabatTables',
           'fused_cape_cin', 'fused_surface_cape_cin',
           'conv_properties_fused', 'min_conv_properties_fused',
           'storm_proxies']
