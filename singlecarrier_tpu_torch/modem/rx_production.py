"""Production RX, block-parallel batch path (``prod_rx_batch``).

Counterpart of ``singlecarrier_tpu/modem/rx_production.py`` for the
one-kernel path, ``prod_rx_batch(fuse_frontend=True)`` with the plane
state of ``prod_rx_init_planes``: every carried quantity of the
production RX is a closed-form function of the raw input (mixer phase
= phase0 * adv^b, FIR halo = downmixed tail of the previous raw block,
hunt window = the previous block's decim planes), so all B*C
(block, channel) rows of a dispatch run at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModemConfig
from ..ops.fused_rx import fused_rx_block


class ProdRxOut(NamedTuple):
    valid: torch.Tensor        # [..] bool packet detected in this block
    bits: torch.Tensor         # [.., bits_per_frame] u8 full packet payload
    matches: torch.Tensor      # [..] i32 trained-chip sign matches
    lag: torch.Tensor          # [..] i32 preamble start (symbol lag in window)
    timing_phase: torch.Tensor  # [..] i32 winning decimation phase
    peak: torch.Tensor         # [..] f32 correlation peak (non-coherent)
    energy: torch.Tensor       # [..] f32 window energy at the peak
    cfo_hz: torch.Tensor       # [..] f32 estimated carrier offset
    eq_error: torch.Tensor     # [..] f32 mean |decision error| over data


def prod_rx_init_planes(cfg: ModemConfig, channels: int, device=None):
    """Plane-typed RX state: ``(phase_r [C], phase_i [C],
    fir_tail_r [C, ntaps-1], fir_tail_i [C, ntaps-1],
    decim_prev_t [cyc, 2, C, n_sym])``, the last in ``cfg.decim_dtype``
    -- the layout the kernels consume."""
    ddt = torch.bfloat16 if cfg.decim_dtype == "bf16" else torch.float32
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.ones((channels,), **f32),
            torch.zeros((channels,), **f32),
            torch.zeros((channels, cfg.ntaps - 1), **f32),
            torch.zeros((channels, cfg.ntaps - 1), **f32),
            torch.zeros((cfg.cycles, 2, channels, cfg.symbols_per_block),
                        dtype=ddt, device=device))


def _auto_cb(C: int, cap: int) -> int:
    """Largest channel-block size <= cap that divides C (the JAX
    kernels' divisibility rule; a blocked kernel of the port picks its
    block with it)."""
    cb = min(cap, C)
    while C % cb:
        cb -= 1
    return cb


def dibits_to_bits(dibits):
    """u8 dibits {0..3} -> the interleaved ProdRxOut.bits layout."""
    d = dibits.to(torch.uint8)
    return torch.stack([d & 1, d >> 1], dim=-1).reshape(
        *d.shape[:-1], -1)


def _decode_out(cfg: ModemConfig, dec, lag, phase_idx, peak) -> ProdRxOut:
    """Assemble ProdRxOut from the decode's stat dict."""
    valid = dec["gated"] & (dec["matches"] > cfg.match_threshold)
    return ProdRxOut(
        valid=valid, bits=dibits_to_bits(dec["dibits"]),
        matches=dec["matches"], lag=lag, timing_phase=phase_idx,
        peak=peak, energy=dec["energy"], cfo_hz=dec["cfo_hz"],
        eq_error=dec["eq_error"],
    )


def prod_rx_batch(cfg: ModemConfig, state, pcm_frames, *,
                  descramble: bool = True, fuse_extract: bool = True,
                  fuse_hunt: bool = True, fuse_frontend: bool = False):
    """Block-parallel batched demod of [B, C, frame_size] int16 frames.

    ``state`` is the plane tuple of :func:`prod_rx_init_planes` (or the
    one a previous call returned).  Returns ``(state, ProdRxOut)`` with
    [B, C, ...] leaves.  Only the one-kernel path is ported:
    ``fuse_frontend=True`` (what ``bench.py`` runs).
    """
    if cfg.frac_timing:
        raise ValueError(
            "cfg.frac_timing=True is not supported by the fused batch "
            "paths (integer-timing extraction only); set "
            "frac_timing=False")
    if not (fuse_frontend and fuse_extract and fuse_hunt):
        raise NotImplementedError(
            "only prod_rx_batch(fuse_frontend=True) is ported; ROADMAP: "
            "two-kernel and streaming paths")
    if not (isinstance(state, tuple) and len(state) == 5
            and all(isinstance(t, torch.Tensor) for t in state)):
        raise NotImplementedError(
            "only the plane state (prod_rx_init_planes) is ported; "
            "ROADMAP: XLA production path (ProdRxState)")
    B, C = pcm_frames.shape[0], pcm_frames.shape[1]
    p0r, p0i, tail0_r, tail0_i, dprev0_t = state
    dec, dlast, (fr, fi, ftr, fti) = fused_rx_block(
        cfg, pcm_frames, p0r, p0i, tail0_r, tail0_i, dprev0_t,
        descramble=descramble)
    out = _decode_out(cfg, dec, dec["lag"], dec["phase_idx"], dec["peak"])
    out = ProdRxOut(*(x.reshape(B, C, *x.shape[1:]) for x in out))
    return (fr, fi, ftr, fti, dlast), out
