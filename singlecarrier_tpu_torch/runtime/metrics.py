"""Streaming metrics / observability.

Counterpart of ``singlecarrier_tpu/runtime/metrics.py``.  The
reference's only observability is a DEBUG2 printf per detected frame
(reference: src/qpsk.c:196-200) and a stderr scatter dump
(qpsk.c:164-168).  Here every block yields structured per-channel
outputs (``ProdRxOut``) and this aggregator reduces them into running
counters on the host: each leaf it reads crosses once, with one
``.cpu()`` (``np.asarray`` of a CUDA tensor raises).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class MetricsAggregator:
    blocks: int = 0
    packets: int = 0
    channels_seen: int = 0
    match_hist: list = field(default_factory=list)
    cfo_sum: float = 0.0
    eq_error_sum: float = 0.0

    def update(self, out) -> None:
        valid = _host(out.valid)
        self.blocks += 1
        self.channels_seen = valid.shape[0] if valid.ndim else 1
        n = int(valid.sum())
        self.packets += n
        if n:
            self.cfo_sum += float(_host(out.cfo_hz)[valid].sum())
            self.eq_error_sum += float(_host(out.eq_error)[valid].sum())
            self.match_hist.append(_host(out.matches)[valid].copy())

    def summary(self) -> dict:
        matches = (np.concatenate(self.match_hist)
                   if self.match_hist else np.zeros(0))
        return {
            "blocks": self.blocks,
            "packets": self.packets,
            "mean_cfo_hz": self.cfo_sum / max(self.packets, 1),
            "mean_eq_error": self.eq_error_sum / max(self.packets, 1),
            "mean_matches": float(matches.mean()) if matches.size else 0.0,
        }
