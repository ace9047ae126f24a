"""PyTorch/CUDA port of xarray_parcel_tpu's convection diagnostics.

Users call it as the JAX package is called: ``xarray_api`` takes Datasets
and DataArrays on the host, runs on the GPU and returns attributed Datasets
(whole, or streamed in column chunks); ``api`` is the same surface on
tensors under the reference's names.  Beneath them are
plain torch functions on tensors with the level axis last: the fused
pipelines (``conv_properties_fused``, ``min_conv_properties_fused``) and
the modular ones (``conv_properties``, ``min_conv_properties``), the storm
proxies and SHIP, the fused CAPE/CIN solve, and the modular path under the
latter: parcel profiles, ``cape_cin`` and its surface, most-unstable and
mixed-layer variants, ``moist_lapse`` and the exact wet bulb.  On the GPU
the fused paths' per-column CAPE/CIN solve, its pre-pass, the
diagnostics tail and their mixed-layer prep, every path's most-unstable
prep, and every other path's mixed-layer neighbour scans, run in
hand-written CUDA kernels
(``csrc/fused_cape.cu``, ``csrc/prepass.cu``, ``csrc/diag_tail.cu``,
``csrc/mix_layer.cu``, ``csrc/most_unstable.cu``, ``csrc/neighbors.cu``,
built at first use by ``_build.py``), on the CPU in their plain torch
twins; every output is
differentiable, the kernels' gradient being their twins' VJP.  The modular
path is otherwise plain torch on either device.
``adiabat`` builds its own moist-adiabat tables; ``parallel`` chunks and
streams column batches and shards them over a mesh of devices; ``deploy``
exports a pipeline as an artifact that a fresh process serves without
building kernels or tables; ``native`` is the C++ host ingest and ``utils``
the timers.  Imports torch and numpy (and xarray if it is installed, else
its own ``xr_lite``).
"""

from . import adiabat, cape, constants, diagnostics, fused, lcl, ops
from . import parcels, pipeline, profile, thermo
from . import fieldset, native, parallel, utils, xr_lite
from . import api, xarray_api
from .adiabat import (AdiabatTables, load_moist_adiabat_lookups, moist_lapse,
                      moist_lapse_integrate)
from .cape import cape_cin, surface_based_cape_cin
from .diagnostics import wet_bulb_temperature
from .fused import fused_cape_cin, fused_surface_cape_cin
from .parcels import mixed_layer_cape_cin, most_unstable_cape_cin
from .pipeline import (conv_properties, conv_properties_fused,
                       min_conv_properties, min_conv_properties_fused,
                       storm_proxies)
from .profile import (add_lcl_to_profile, parcel_profile,
                      parcel_profile_with_lcl)

__version__ = '0.1.0'

__all__ = ['adiabat', 'cape', 'constants', 'diagnostics', 'fused', 'lcl',
           'ops', 'parcels', 'pipeline', 'profile', 'thermo',
           'fieldset', 'native', 'parallel', 'utils', 'xr_lite', 'api',
           'xarray_api', 'load_moist_adiabat_lookups',
           'AdiabatTables', 'moist_lapse', 'moist_lapse_integrate',
           'cape_cin', 'surface_based_cape_cin', 'wet_bulb_temperature',
           'fused_cape_cin', 'fused_surface_cape_cin',
           'mixed_layer_cape_cin', 'most_unstable_cape_cin',
           'conv_properties', 'conv_properties_fused',
           'min_conv_properties', 'min_conv_properties_fused',
           'storm_proxies', 'add_lcl_to_profile', 'parcel_profile',
           'parcel_profile_with_lcl']
