"""Where the surfaces that take host data run.

Every entry point that takes host data (numpy arrays, DataArrays,
Datasets) has a ``device=None`` argument, which means the GPU; only an
explicit ``device='cpu'`` runs on the CPU.  Functions that take tensors
follow their tensors and never come here.
"""

import numpy as np
import torch


def resolve_device(device=None):
    """The ``torch.device`` for a surface's ``device`` argument: ``None``
    is the current CUDA device, and raises when there is none (no silent
    fall to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: host data runs on the GPU by default; pass "
                "device='cpu' to run on the CPU")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


def to_tensor(x, device):
    """A tensor or a host array as a tensor on ``device``.  A host array
    that is not row-major or not writable (a transposed or broadcast view)
    is copied in C order first: the level axis of what reaches the device
    is then contiguous, whatever the view's strides were."""
    if torch.is_tensor(x):
        return x.to(device)
    x = np.asarray(x)
    if not x.flags.writeable or not x.flags.c_contiguous:
        x = np.array(x, order='C')
    return torch.from_numpy(x).to(device)
