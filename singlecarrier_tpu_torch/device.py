"""The package's device rule, in one place, and the two points where
arithmetic on the card must be pinned to the JAX package's.

State constructors, ``tx_stream``, ``channel``, ``ber_run``, the CLI and
``interop.*_from_numpy`` make their tensors on the card when ``device``
is ``None`` and raise where there is none; a caller who wants the CPU
says ``device="cpu"`` (the tests do).  The processing entry points take
their device from the state they are given and move the PCM to it.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch versions on the "
            "host")
    return torch.device("cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=64)
def on_device(fn, args: tuple, device) -> torch.Tensor:
    """``fn(*args)`` (a numpy table) as a tensor on ``device``, uploaded
    once per (table, device): a per-block loop must not wait on host
    copies."""
    return torch.from_numpy(fn(*args)).to(device)


def require_true_f32(t: torch.Tensor) -> None:
    """Refuse a CUDA tensor while f32 matmuls may run in TF32: every f32
    contraction of the plain paths (the hunt, the FIR band products, the
    CFO DFT, the LS fits) is meant in true f32, as the JAX package runs
    them."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain paths need true f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def to_int16(x: torch.Tensor) -> torch.Tensor:
    """Float -> int16 as XLA casts: NaN to 0, saturated to [-32768,
    32767], then truncated toward zero.  A plain ``.to(torch.int16)``
    wraps out-of-range values (40000.7 -> -25536), XLA gives 32767."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return x.clamp(-32768.0, 32767.0).to(torch.int16)
