"""The card: its published peaks, its power limit, and the program's
moist-adiabat tables cached inside the checkout.

Peaks are one H100 SXM's, from NVIDIA's data sheet, at the full 700 W:
HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 and 34 TFLOP/s in float64
without the tensor cores.  A card set below 700 W runs slower under load,
so every roofline share is printed beside the power limit read here.
"""

import os
import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {4: 67e12, 8: 34e12}        # by element size in bytes

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '.cache')


def least_seconds(nbytes, ops, itemsize):
    """The least time the card could take for work that moves ``nbytes``
    and does ``ops`` operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[itemsize])


def power_limit():
    """``nvidia-smi``'s name and power limit of the first card, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, limit = [x.strip() for x in out.rsplit(',', 1)]
    return {'name': name, 'power_limit': limit}


def tables(device, dtype):
    """The program's moist-adiabat coefficients for ``device`` and
    ``dtype``: loaded from the checkout's cache file, or built (the first
    run of a checkout) and saved there."""
    import torch
    from xarray_parcel_tpu_torch.adiabat import AdiabatTables
    suffix = {torch.float32: 'f32', torch.float64: 'f64'}[dtype]
    path = os.path.join(CACHE_DIR, f'adiabat_coeffs_{suffix}.npz')
    if os.path.exists(path):
        return AdiabatTables.load(path, device, dtype)
    os.makedirs(CACHE_DIR, exist_ok=True)
    built = AdiabatTables.build(device, dtype)
    built.save(path)
    return built
