"""NaN-safe transcendental wrappers, the NaN-preserving sign and the
scalar-to-tensor helper.

NaN is the library's universal missing-value sentinel.  ``safe_log`` and
``safe_exp`` evaluate on a finite dummy where the input is NaN and put the
NaN back afterwards, so a masked NaN level never enters the arithmetic
(the forward value is identical to ``torch.log``/``torch.exp``).
"""

import torch


def notnan(x):
    """``~isnan(x)`` as one comparison (NaN is the only value unequal to
    itself)."""
    return x == x


def safe_log(x):
    """``torch.log(x)`` that never evaluates a NaN input."""
    bad = torch.isnan(x)
    return torch.where(bad, torch.nan, torch.log(torch.where(bad, 1.0, x)))


def safe_exp(x):
    """``torch.exp(x)`` that never evaluates a NaN input."""
    bad = torch.isnan(x)
    return torch.where(bad, torch.nan, torch.exp(torch.where(bad, 0.0, x)))


def tensor_like(x, ref):
    """``x`` as a tensor for arithmetic with ``ref``: a Python number takes
    ``ref``'s dtype and device; a tensor is returned as it is, and one on
    another device raises (no silent copy between devices)."""
    if not torch.is_tensor(x):
        return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    if x.device != ref.device:
        raise ValueError(f'tensor on {x.device} mixed with one on '
                         f'{ref.device}')
    return x


def nan_sign(x):
    """``sign(x)`` that keeps NaN (``torch.sign(nan)`` is 0, while the
    crossing finder needs NaN to mark a poisoned level, as ``jnp.sign``
    gives)."""
    return torch.where(torch.isnan(x), torch.nan, torch.sign(x))
