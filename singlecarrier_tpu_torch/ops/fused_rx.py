"""The one-kernel RX of the JAX package, as three kernels on the card.

Counterpart of ``singlecarrier_tpu/ops/fused_rx.py::fused_rx_block``.
The Pallas kernel walks the time blocks of a channel block in order and
carries the previous block's decim planes and the FIR halo in VMEM.
CUDA blocks run in no order, so the port splits the kernel where that
carry sits:

  1. ``frontend.frontend_decim`` -- every (block, channel) row at once;
     the halo of row b*C + ch is recomputed from row (b-1)*C + ch's raw
     tail (the closed-form phase recursion makes it exact).  With
     ``cfg.mixer_fold`` it is the mixer-folded kernel
     (``_fused_rx_kernel_folded``), whose halo is the raw tail itself;
  2. ``decode.hunt`` -- row n's window reads row n - C's planes (or the
     carried ``dprev0``);
  3. ``decode.extract_decode``, or ``decode.extract_gate`` for
     ``stage="gate"`` (2 and 3 through
     ``decode.fused_hunt_decode_decim``).

The price is one write and two reads of the decim planes in device
memory, which the Pallas kernel avoided.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig
from ..dsp.mixer import downmix_tail
from .decode import check_stage, fused_hunt_decode_decim
from .frontend import frontend_decim


@functools.lru_cache(maxsize=32)
def _advances(cfg: ModemConfig, B: int, dev):
    """adv^b for b in [0, B]: the complex64 numpy table (float64 phase ->
    exactly-unit complex64) and its first B entries as [2, B] f32 planes
    on ``dev``, uploaded once per (config, B, device)."""
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    advs = np.exp(1j * w_ * cfg.frame_size * np.arange(B + 1)).astype(
        np.complex64)
    return advs, torch.from_numpy(
        np.stack([advs.real[:B], advs.imag[:B]])).to(dev)


@functools.lru_cache(maxsize=32)
def _last_advances(cfg: ModemConfig, B: int, dev) -> torch.Tensor:
    """adv^(B-1) and adv^B as [2, 2] f32 (row: power, column: real and
    imaginary part) on ``dev``, uploaded once per (config, B, device): a
    dispatch must not wait on a host copy."""
    advs = _advances(cfg, B, dev)[0]
    return torch.from_numpy(np.stack([advs[B - 1:].real,
                                      advs[B - 1:].imag], 1)).to(dev)


def fused_rx_block(cfg: ModemConfig, pcm_frames, p0r, p0i, tail0_r,
                   tail0_i, dprev0_t, *, descramble: bool = True,
                   stage: str = "full"):
    """Run the RX over [B, C, frame_size] int16 frames.

    Args:
      p0r/p0i:         [C] mixer phasor planes entering block 0.
      tail0_r/tail0_i: [C, ntaps-1] DOWNMIXED FIR halo planes.
      dprev0_t:        [cyc, 2, C, n_sym] carried decim planes
                       (cfg.decim_dtype).

    Returns ``(dec, dlast, (fin_pr, fin_pi, fin_tr, fin_ti))``: the stat
    dict with [B*C] leaves, the [cyc, 2, C, n_sym] stream state leaving
    block B-1, and the closed-form final phase/tail planes.
    ``stage="gate"`` stops each row after its energy gate (phase 1 of
    ``modem.rx_gated``); the stream state is the full stage's.
    """
    check_stage(stage)
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    B, C = pcm_frames.shape[0], pcm_frames.shape[1]
    dev = pcm_frames.device

    adv = _advances(cfg, B, dev)[1]
    decim = frontend_decim(cfg, pcm_frames, p0r, p0i, tail0_r, tail0_i, adv)
    dprev0 = dprev0_t.to(decim.dtype).contiguous()
    dec = fused_hunt_decode_decim(cfg, dprev0, decim, channels=C,
                                  descramble=descramble, stage=stage)
    dlast = decim[:, :, (B - 1) * C:].clone()

    # ---- closed-form final phase + tail (O(C) glue) ----
    last = _last_advances(cfg, B, dev)

    def _ph(k):                        # p0 * adv^(B-1+k)
        ar, ai = last[k, 0], last[k, 1]
        return p0r * ar - p0i * ai, p0r * ai + p0i * ar

    fr, fi = _ph(1)
    mag = torch.sqrt(fr * fr + fi * fi)
    x_t = pcm_frames[-1, :, n - halo:].float() * (1.0 / cfg.tx_amplitude)
    lr, li = _ph(0)
    fin_tr, fin_ti = downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                                  lr[:, None], li[:, None])
    return dec, dlast, (fr / mag, fi / mag, fin_tr, fin_ti)
