"""Detection-gated two-phase RX: the sparse-deployment wrapper.

Counterpart of ``singlecarrier_tpu/modem/rx_gated.py``.  The full path
runs the decode tail (CFO search, de-rotation, train, refit, refine) on
every block-channel although only a small share of them detects.  For
sparse or monitoring deployments a two-phase pipeline does less:

  phase 1  ``fused_rx_block(stage="gate")``: front-end + hunt +
           extraction + energy gate on every row, with the same carried
           stream state as the full path;
  compact  detected-first ordering (a stable argsort of the gate flags:
           the order of the compacted rows is part of the output) and a
           gather of each detection's (prev, cur) raw PCM pair with its
           closed-form mixer-phase and FIR-tail seeds;
  phase 2  ``fused_rx_block`` over the compacted [2, K] pair batch:
           block 0 rebuilds the hunt window, block 1's stats are the
           decode, equal to the full path's by decisions.

A detection at block 0 of a dispatch needs the previous dispatch's last
PCM block as its pair's prev, and that pair's FIR-tail seed needs the
raw halo of the block before that.  Both ride :class:`GatedRxState`, so
back-to-back :func:`prod_rx_batch_gated` calls decode packets that span
the dispatch seam exactly like one big dispatch.

K (``max_detections``) is a capacity, not a count: rows past the number
of gate hits decode garbage and are masked; if more than K
block-channels fire, ``out["count"]`` > K reports the truncation.  Phase
2 runs 2K rows through the whole RX to use K of them, as the JAX
package does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import ModemConfig
from ..dsp.mixer import downmix_tail
from ..ops.fused_rx import fused_rx_block
from .rx_production import (_frames_on, _plane_dtype, dibits_to_bits,
                            prod_rx_init_planes)


class GatedRxState(NamedTuple):
    """Streaming state of the gated pipeline.

    ``planes`` is the plane tuple of ``prod_rx_init_planes``; the two PCM
    leaves carry what phase 2 needs to rebuild a block-0 detection's
    pair across the dispatch seam.
    """
    planes: tuple
    pcm_prev: torch.Tensor        # [C, n] i16 last block of prev dispatch
    pcm_prev2_tail: torch.Tensor  # [C, ntaps-1] i16 halo of the block before


def prod_rx_gated_init(cfg: ModemConfig, channels: int,
                       device=None) -> GatedRxState:
    """Initial gated state, on the card unless ``device`` says
    otherwise."""
    planes = prod_rx_init_planes(cfg, channels, device)
    i16 = dict(dtype=torch.int16, device=planes[0].device)
    return GatedRxState(
        planes=planes,
        pcm_prev=torch.zeros((channels, cfg.frame_size), **i16),
        pcm_prev2_tail=torch.zeros((channels, cfg.ntaps - 1), **i16))


@functools.lru_cache(maxsize=32)
def _pair_advances(cfg: ModemConfig, B: int, dev):
    """[4, B + 1] f32 on ``dev``: real and imaginary planes of
    adv^(b-1) and adv^(b-2), tabulated in float64 and cast to complex64;
    uploaded once per (config, B, device)."""
    w_ = -2.0 * np.pi * cfg.center / cfg.fs
    b = np.arange(B + 1)
    m1 = np.exp(1j * w_ * cfg.frame_size * (b - 1.0)).astype(np.complex64)
    m2 = np.exp(1j * w_ * cfg.frame_size * (b - 2.0)).astype(np.complex64)
    return torch.from_numpy(
        np.stack([m1.real, m1.imag, m2.real, m2.imag])).to(dev)


def _pair_operands(cfg: ModemConfig, gated, pcm, p0r, p0i, K, pcm_prev,
                   pcm_prev2_tail):
    """Detected-first ordering + gather of the phase-2 pair operands.

    Returns ``(pairs [2, K, n], pr, pi, tail_r, tail_i, order, b_idx,
    c_idx)``: the phase entering a pair is that of block b-1 (adv^(b-1);
    for b = 0 the phase at the start of the carried prev block), and its
    FIR tail is the downmixed halo of block b-2's PCM.
    """
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    B, C = pcm.shape[0], pcm.shape[1]

    flat = gated.reshape(-1)
    order = torch.argsort(~flat, stable=True)[:K]           # detected first
    if K > flat.shape[0]:
        # capacity exceeds the dispatch: pad with row 0; the pad sits at
        # i >= count and is masked by the caller's in-capacity mask
        order = torch.nn.functional.pad(order, (0, K - flat.shape[0]))
    b_idx = order // C
    c_idx = order % C
    pcm_f = pcm.reshape(B * C, n)
    cur = pcm_f[order]
    prev = torch.where((b_idx > 0)[:, None],
                       pcm_f[(order - C).clamp_min(0)], pcm_prev[c_idx])
    ar, ai, ar2, ai2 = _pair_advances(cfg, B, pcm.device)[:, b_idx]
    q_r, q_i = p0r[c_idx], p0i[c_idx]
    pr = q_r * ar - q_i * ai
    pi = q_r * ai + q_i * ar
    tpr = q_r * ar2 - q_i * ai2
    tpi = q_r * ai2 + q_i * ar2
    raw_t = torch.where(
        (b_idx > 1)[:, None],
        pcm_f[(order - 2 * C).clamp_min(0)][:, n - halo:],
        torch.where((b_idx == 1)[:, None], pcm_prev[c_idx][:, n - halo:],
                    pcm_prev2_tail[c_idx]))
    x_t = raw_t.float() / cfg.tx_amplitude
    tl_r, tl_i = downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                              tpr[:, None], tpi[:, None])
    return (torch.stack([prev, cur], 0), pr, pi, tl_r, tl_i, order, b_idx,
            c_idx)


def prod_rx_batch_gated(cfg: ModemConfig, state: GatedRxState, pcm_frames,
                        *, max_detections: int, block_channels=None,
                        descramble: bool = True, interpret: bool = False):
    """Two-phase gated RX over [B, C, frame_size] int16 frames.

    Returns ``(state', out)``.  ``out`` holds the phase-1 gate summary
    (``count`` = gate hits this dispatch; > max_detections means
    truncation) plus compacted phase-2 results, each [K]-leading:
    ``valid`` (gate and matches), ``bits``, ``dibits`` [K, frame_symbols],
    ``matches``, ``lag``, ``timing_phase``, ``peak``, ``energy``,
    ``cfo_hz``, ``eq_error``, and the stream coordinates ``block_idx`` /
    ``channel_idx`` of each row.  Runs on the state's device.
    ``block_channels`` and ``interpret`` only size the TPU kernels;
    accepted and ignored.
    """
    pcm_frames = _frames_on(state.planes, pcm_frames)
    B = pcm_frames.shape[0]
    halo = cfg.ntaps - 1
    K = max_detections
    p0r, p0i, t0r, t0i, dp = state.planes

    # ---- phase 1: gate ----
    dec_g, dlast, (fr, fi, ftr, fti) = fused_rx_block(
        cfg, pcm_frames, p0r, p0i, t0r, t0i, dp, stage="gate",
        descramble=descramble)
    gated = dec_g["gated"]
    count = gated.sum().to(torch.int32)

    # ---- compact ----
    pairs, pr, pi, tl_r, tl_i, _, b_idx, c_idx = _pair_operands(
        cfg, gated, pcm_frames, p0r, p0i, K, state.pcm_prev,
        state.pcm_prev2_tail)

    # ---- phase 2: decode the compacted pairs ----
    dp0 = torch.zeros((cfg.cycles, 2, K, cfg.symbols_per_block),
                      dtype=_plane_dtype(cfg), device=pcm_frames.device)
    dec2, _, _ = fused_rx_block(cfg, pairs, pr, pi, tl_r, tl_i, dp0,
                                descramble=descramble)
    # block 1's rows are the decode (block 0 rebuilt the hunt window)
    dec2 = {k: v[K:] for k, v in dec2.items()}

    in_cap = torch.arange(K, device=count.device) < count.clamp_max(K)
    out = {
        "count": count,
        "block_idx": b_idx.to(torch.int32),
        "channel_idx": c_idx.to(torch.int32),
        "valid": (dec2["gated"] & in_cap
                  & (dec2["matches"] > cfg.match_threshold)),
        "bits": dibits_to_bits(dec2["dibits"]),
        "dibits": dec2["dibits"],
        "matches": dec2["matches"],
        "lag": dec2["lag"],
        "timing_phase": dec2["phase_idx"],
        "peak": dec2["peak"],
        "energy": dec2["energy"],
        "cfo_hz": dec2["cfo_hz"],
        "eq_error": dec2["eq_error"],
    }

    n = cfg.frame_size
    new_state = GatedRxState(
        planes=(fr, fi, ftr, fti, dlast),
        pcm_prev=pcm_frames[-1].clone(),
        pcm_prev2_tail=(pcm_frames[-2, :, n - halo:] if B >= 2
                        else state.pcm_prev[:, n - halo:]).clone())
    return new_state, out
