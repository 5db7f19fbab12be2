"""Symbol-rate decimation (``singlecarrier_tpu/dsp/decimate.py``).

The reference's strided copy ``decimated[i] = filtered[i*CYCLES +
rx_timing]`` (src/qpsk.c:157-162) as a static-phase slice (the
production path) and as a gather at per-channel offsets (the faithful
path, whose ``rx_timing`` is per-channel state: qpsk.c:219).
"""

from __future__ import annotations

import torch


def decimate(x: torch.Tensor, cycles: int, phase: int = 0) -> torch.Tensor:
    """Static-phase decimation: ``x[..., phase::cycles]``."""
    return x[..., phase::cycles]


def decimate_at(x: torch.Tensor, offset, cycles: int,
                n_out: int) -> torch.Tensor:
    """Gather ``x[..., offset + i*cycles]`` for i in [0, n_out).

    ``offset`` is an int or an int tensor of per-channel offsets [...]
    (qpsk.c:161 with ``rx_timing`` as the offset into the combined
    2-frame buffer).  As the JAX package's ``take_along_axis``: a
    negative index counts from the end, one still out of range reads
    NaN.
    """
    n = x.shape[-1]
    offset = torch.as_tensor(offset, dtype=torch.int64, device=x.device)
    idx = offset[..., None] + cycles * torch.arange(n_out, device=x.device)
    idx = torch.where(idx < 0, idx + n, idx).expand(*x.shape[:-1], n_out)
    out = torch.gather(x, -1, idx.clamp(0, n - 1))
    return out.masked_fill((idx < 0) | (idx >= n), float("nan"))
