"""Streaming block loop.

Counterpart of ``singlecarrier_tpu/runtime/stream.py``.  The reference's
main loop is a blocking fread/demod/fwrite loop over 1880-sample
chunks (reference: src/qpsk.c:436-458).  This one is state-in/state-out
over [channels, frame_size] blocks: the host (or the native IO engine,
native/scio.cc) feeds int16 blocks, the batched XLA-path RX
(``prod_rx_frame``, plain PyTorch, batched over its leading dimensions)
consumes them, and the per-channel state stays on the device between
calls -- nothing crosses but the PCM in and what the caller reads out.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..config import ModemConfig
from ..device import require_true_f32
from ..modem.rx_production import ProdRxOut, prod_rx_frame, prod_rx_init
from .metrics import MetricsAggregator


class StreamDemodulator:
    """Stateful batched demodulator over a stream of PCM blocks.

    Replaces the reference main RX loop (qpsk.c:436-458).  The state is
    made on the card unless ``device`` says otherwise, and each block
    runs there; on the card the plain path's f32 matmuls need TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``).  Example::

        demod = StreamDemodulator(cfg, n_channels=4096)
        for block in blocks:                # [n_channels, frame_size] int16
            out = demod.push(block)
            packets = demod.collect_packets(out)
    """

    def __init__(self, cfg: ModemConfig, n_channels: int, *,
                 descramble: bool = True, metrics: bool = True,
                 validate: bool = False, device=None):
        self.cfg = cfg
        self.n_channels = n_channels
        self.descramble = descramble
        self.validate = validate
        self.state = prod_rx_init(cfg, (n_channels,), device=device)
        require_true_f32(self.state.phase.real)
        self.metrics: Optional[MetricsAggregator] = (
            MetricsAggregator() if metrics else None)
        self.blocks_processed = 0

    def push(self, pcm_block) -> ProdRxOut:
        """Demodulate one [n_channels, frame_size] block (numpy array or
        tensor, on any device)."""
        if tuple(pcm_block.shape) != (self.n_channels, self.cfg.frame_size):
            raise ValueError(
                f"expected {(self.n_channels, self.cfg.frame_size)}, "
                f"got {tuple(pcm_block.shape)}")
        if self.validate:
            from .validate import assert_pcm_block, assert_rx_state
            assert_pcm_block(self.cfg, pcm_block, self.n_channels)
            assert_rx_state(self.cfg, self.state, self.n_channels)
        self.state, out = prod_rx_frame(self.cfg, self.state,
                                        torch.as_tensor(pcm_block),
                                        descramble=self.descramble)
        self.blocks_processed += 1
        if self.metrics is not None:
            self.metrics.update(out)
        return out

    def run(self, blocks: Iterable) -> Iterator[ProdRxOut]:
        for block in blocks:
            yield self.push(block)

    @staticmethod
    def collect_packets(out: ProdRxOut):
        """(channel, bits) pairs for every detected packet in a block."""
        valid = out.valid.cpu().numpy()
        bits = out.bits.cpu().numpy()
        return [(int(c), bits[c]) for c in np.nonzero(valid)[0]]

    def flush(self) -> ProdRxOut:
        """Feed one silent block so the 1-block hunt latency drains."""
        return self.push(torch.zeros(
            (self.n_channels, self.cfg.frame_size), dtype=torch.int16,
            device=self.state.phase.device))
