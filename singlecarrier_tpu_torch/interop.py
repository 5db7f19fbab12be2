"""Carry RX state across the two packages.

The system has no weights; what crosses between the JAX package and the
port is the plane state of ``prod_rx_init_planes``: ``(phase_r,
phase_i, fir_tail_r, fir_tail_i, decim_prev_t)`` as numpy arrays, where
``decim_prev_t`` may be ``ml_dtypes.bfloat16``.  ``torch.from_numpy``
refuses that dtype, so bf16 crosses as its raw 16-bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def planes_from_numpy(planes, device=None):
    """JAX plane state (numpy arrays) -> tuple of torch tensors."""
    return tuple(_to_torch(np.asarray(a), device) for a in planes)


def planes_to_numpy(planes):
    """Torch plane state -> tuple of numpy arrays (bf16 as
    ``ml_dtypes.bfloat16``, the JAX package's host type)."""
    return tuple(_to_numpy(t) for t in planes)
