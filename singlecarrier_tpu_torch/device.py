"""The package's device rule, in one place.

State constructors and ``interop.*_from_numpy`` make their tensors on
the card when ``device`` is ``None`` and raise where there is none; a
caller who wants the CPU says ``device="cpu"`` (the tests do).  The
processing entry points take their device from the state they are given
and move the PCM to it.
"""

from __future__ import annotations

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
