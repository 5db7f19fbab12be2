"""Production RX: the XLA path, the block-parallel batch path and the
streaming paths.

Counterpart of ``singlecarrier_tpu/modem/rx_production.py``:

  * the XLA path (``prod_rx_frame``, ``prod_rx_stream``,
    ``prod_rx_backend``): plain PyTorch, no kernel -- the mixer and the
    banded FIR (``dsp/``), the plain hunt, the bf16 CFO DFT, the LS fit
    and the atan2 refinement (``adaptive/ls_equalizer``).  It is the
    oracle the kernel paths are held to;
  * ``prod_rx_batch`` (every flag combination, ``cfg.mixer_fold``
    included): every carried quantity is a closed-form function of the
    raw input (mixer phase = phase0 * adv^b, FIR halo = downmixed tail
    of the previous raw block, hunt window = the previous block's decim
    planes), so all B*C (block, channel) rows of a dispatch run at once;
  * ``prod_rx_stream_pallas`` (its plane-typed body; the full-rate
    front-end followed by the fused decode under ``cfg.frac_timing``, or
    by ``prod_rx_backend`` with ``fuse_decode=False``) and
    ``prod_rx_stream_superstep``.

State is either the plane tuple of :func:`prod_rx_init_planes` or the
public complex :class:`ProdRxState`; the same type comes back.  Every
entry point runs on the device its state lies on and moves the PCM
there.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..adaptive.ls_equalizer import (ls_decode, ls_refit, ls_train,
                                     phase_refine, window_matrix)
from ..config import ModemConfig
from ..constants import PREAMBLE_VALUES, rrc_taps
from ..device import on_device, require_true_f32, resolve_device
from ..dsp.fftops import estimate_cfo
from ..dsp.fir import fir_block
from ..dsp.mixer import downmix_tail, mix_block
from ..scramble import scramble_dibits
from ..ops.decode import (fused_decode, fused_decode_extract,
                          fused_hunt_decode_decim)
from ..ops.frontend import fused_frontend, fused_frontend_decim
from ..ops.fused_rx import _advances, fused_rx_block

_F32 = torch.float32

# rows of the plain hunt done at once: its correlation intermediate is
# [rows, 2*cycles, n_lags*corr_segments] f32, 120 KB per row at the
# reference numerology, so 16384 rows keep it under 2 GB
_HUNT_ROWS = 16384


class ProdRxState(NamedTuple):
    phase: torch.Tensor        # [..] c64 downmix phasor
    fir_tail: torch.Tensor     # [.., ntaps-1] c64 matched-filter halo
    decim_prev: torch.Tensor   # [.., cycles, n_sym] prev block, all phases


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


def _plane_dtype(cfg: ModemConfig):
    return torch.bfloat16 if cfg.decim_dtype == "bf16" else _F32


def prod_rx_init(cfg: ModemConfig, batch_shape=(), device=None) -> ProdRxState:
    """Initial complex RX state (unit phasor, zero halo, zero planes),
    on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    c64 = dict(dtype=torch.complex64, device=dev)
    return ProdRxState(
        phase=torch.ones(tuple(batch_shape), **c64),
        fir_tail=torch.zeros((*batch_shape, cfg.ntaps - 1), **c64),
        decim_prev=torch.zeros(
            (*batch_shape, cfg.cycles, cfg.symbols_per_block), **c64))


def prod_rx_init_planes(cfg: ModemConfig, channels: int, device=None):
    """Plane-typed RX state: ``(phase_r [C], phase_i [C],
    fir_tail_r [C, ntaps-1], fir_tail_i [C, ntaps-1],
    decim_prev_t [cyc, 2, C, n_sym])``, the last in ``cfg.decim_dtype``
    -- the layout the kernels consume.  On the card unless ``device``
    says otherwise."""
    dev = resolve_device(device)
    f32 = dict(dtype=_F32, device=dev)
    return (torch.ones((channels,), **f32),
            torch.zeros((channels,), **f32),
            torch.zeros((channels, cfg.ntaps - 1), **f32),
            torch.zeros((channels, cfg.ntaps - 1), **f32),
            torch.zeros((cfg.cycles, 2, channels, cfg.symbols_per_block),
                        dtype=_plane_dtype(cfg), device=dev))


def _planes_t(decim_prev) -> torch.Tensor:
    """Complex [C, cyc, n_sym] -> f32 planes [cyc, 2, C, n_sym]."""
    return torch.stack([decim_prev.real, decim_prev.imag],
                       dim=0).permute(2, 0, 1, 3)


def _complex_planes(dprev_t) -> torch.Tensor:
    """Planes [cyc, 2, C, n_sym] -> complex [C, cyc, n_sym] (widened to
    f32: exact for bf16 planes)."""
    return torch.complex(dprev_t[:, 0].permute(1, 0, 2).float(),
                         dprev_t[:, 1].permute(1, 0, 2).float())


def state_to_planes(cfg: ModemConfig, state: ProdRxState):
    """ProdRxState -> the plane tuple (one-time conversion).  The
    ``.real`` / ``.imag`` views are made contiguous: the kernels take
    plain pointers."""
    return (state.phase.real.contiguous(), state.phase.imag.contiguous(),
            state.fir_tail.real.contiguous(),
            state.fir_tail.imag.contiguous(),
            _planes_t(state.decim_prev).to(_plane_dtype(cfg)).contiguous())


def planes_to_state(planes) -> ProdRxState:
    """Plane tuple -> ProdRxState (one-time conversion)."""
    pr, pi_, tr, ti, dprev_t = planes
    return ProdRxState(phase=torch.complex(pr, pi_),
                       fir_tail=torch.complex(tr, ti),
                       decim_prev=_complex_planes(dprev_t))


# ------------------------------------------------- the plain-tensor hunt

@functools.lru_cache(maxsize=8)
def _segment_band_matrix(n_lags: int, n_segments: int, p: int):
    """Banded correlation matrix B[w, l*n_seg + s] = v[16s + k] at
    w = l + 16s + k: one dense [win, n_lags*n_seg] product computes
    every (lag, segment) partial sum of the real-kernel PN correlation
    (|corr|^2 = 2 |...|^2 for the (1+j) chips)."""
    v = PREAMBLE_VALUES.astype(np.float32)
    seg = p // n_segments
    win = n_lags + p - 1
    b = np.zeros((win, n_lags * n_segments), np.float32)
    for l in range(n_lags):
        for s in range(n_segments):
            for k in range(seg):
                b[l + s * seg + k, l * n_segments + s] = v[s * seg + k]
    return b


@functools.lru_cache(maxsize=8)
def _energy_band_matrix(n_lags: int, p: int):
    """Ones band E[w, l] = 1 for l <= w < l + p: the per-lag window
    energy of the squared-magnitude planes."""
    win = n_lags + p - 1
    b = np.zeros((win, n_lags), np.float32)
    for l in range(n_lags):
        b[l:l + p, l] = 1.0
    return b


def _hunt_corr(cfg: ModemConfig, planes, mat):
    """Correlation product in ``cfg.hunt_dtype``: ``planes``
    [..., rows, win] f32 against the +/-1/0 chip matrix ``mat`` (f32).

    The operands are rounded to the hunt dtype and the product runs in
    true f32, which is what an f32-accumulating bf16 or int8 matmul
    computes: the products against +/-1/0 are exact, and the int8 sums
    (16 terms of at most 127) are exact integers.
    """
    require_true_f32(planes)
    if cfg.hunt_dtype == "int8":
        q = torch.clamp(torch.round(planes.float() * cfg.hunt_int8_scale),
                        -127.0, 127.0)
        return torch.matmul(q, mat)
    if cfg.hunt_dtype == "bf16":
        return torch.matmul(planes.to(torch.bfloat16).float(), mat)
    return torch.matmul(planes.float(), mat)


def _hunt_power_scale(cfg: ModemConfig) -> float:
    """2x for the (1+j) chip factor, /s^2 to undo the int8 quantization
    so the peak stays in matched-filter units for the energy gate."""
    if cfg.hunt_dtype == "int8":
        return float(2.0 / (cfg.hunt_int8_scale ** 2))
    return 2.0


def _hunt_metric(cfg: ModemConfig, power, sq):
    """Hunt argmax statistic from the raw segmented power.

    ``power``: [..., cyc, n_lags]; ``sq``: squared window magnitude
    [..., cyc, n_lags+p-1].  "espan": power over the span energy shared
    across the phases -- the squared planes summed in ascending phase
    order, then one band product; "energy": power over each phase's own
    window energy (a band product a phase); "none": the raw power.
    """
    if cfg.hunt_norm == "none":
        return power
    require_true_f32(sq)
    eband = on_device(_energy_band_matrix,
                       (cfg.symbols_per_block, cfg.preamble_length),
                       sq.device)
    sq = sq.float()
    if cfg.hunt_norm == "energy":
        return power / (torch.matmul(sq, eband) + 1e-12)
    ssum = sq[..., 0, :]
    for c in range(1, sq.shape[-2]):
        ssum = ssum + sq[..., c, :]
    energy = torch.matmul(ssum, eband)
    return power / (energy[..., None, :] + 1e-12)


def _hunt_planes_rows(cfg: ModemConfig, windows, col_offset: int,
                      frac: bool):
    n_lags, p = cfg.symbols_per_block, cfg.preamble_length
    n_seg = cfg.corr_segments
    dev = windows.device
    mat = on_device(_segment_band_matrix, (n_lags, n_seg, p), dev)
    N, cyc = windows.shape[0], windows.shape[1]
    w = windows[..., col_offset:col_offset + n_lags + p - 1]
    corr = _hunt_corr(cfg, w.reshape(N, cyc * 2, -1), mat)
    corr = corr.reshape(N, cyc, 2, n_lags, n_seg)
    power = _hunt_power_scale(cfg) * (corr * corr).sum(dim=(-3, -1))
    metric = _hunt_metric(cfg, power,
                          w[:, :, 0] * w[:, :, 0] + w[:, :, 1] * w[:, :, 1])

    # argmax of the flattened [cyc * n_lags] metric, first maximum: the
    # lowest lag among a phase's maxima, strict > across ascending phases;
    # a NaN counts as the maximum, as in jnp.argmax (amax propagates it)
    lags = torch.arange(n_lags, device=dev)
    mx = metric.amax(dim=-1)                                # [N, cyc]
    hit = (metric == mx[..., None]) | torch.isnan(metric)
    first = torch.where(hit, lags, n_lags).amin(dim=-1)     # [N, cyc]
    best_m, best_lag = mx[:, 0], first[:, 0]
    best_ph = torch.zeros_like(best_lag)
    for c in range(1, cyc):
        upd = (mx[:, c] > best_m) | (torch.isnan(mx[:, c])
                                     & ~torch.isnan(best_m))
        best_m = torch.where(upd, mx[:, c], best_m)
        best_lag = torch.where(upd, first[:, c], best_lag)
        best_ph = torch.where(upd, torch.full_like(best_ph, c), best_ph)
    peak = power[torch.arange(N, device=dev), best_ph, best_lag]
    res = (best_lag.to(torch.int32), best_ph.to(torch.int32), peak)
    if not frac:
        return res
    # Sub-sample timing: (lag, phase) is the absolute sample t =
    # lag*cyc + phase; the power at t-1 / t+1 brackets the peak and a
    # parabola through the three gives the fractional offset.
    pt = power.transpose(-1, -2).reshape(N, -1)             # time order
    t = (best_lag * cyc + best_ph)[:, None]
    tmax = pt.shape[-1] - 1
    pm = torch.gather(pt, 1, (t - 1).clamp(0, tmax))[:, 0]
    pp = torch.gather(pt, 1, (t + 1).clamp(0, tmax))[:, 0]
    denom = pm + pp - 2.0 * peak
    fr = torch.where(denom < -1e-12, 0.5 * (pm - pp) / denom, 0.0)
    fr = fr.clamp(-0.5, 0.5)
    t = t[:, 0]
    return (*res, torch.where((t > 0) & (t < tmax), fr, 0.0))


def _hunt_planes(cfg: ModemConfig, windows, *, col_offset: int = 0,
                 frac: bool = False):
    """Plane-typed hunt: ``windows`` [N, cyc, 2, >=2*n_sym] f32
    (real/imag planes on axis 2).  Returns (lag, phase_idx, peak), with
    ``frac`` also the parabolic sub-sample offset in [-0.5, 0.5].
    ``col_offset`` skips leading pad columns (the fused-extract path
    stores windows left-padded by eq_length//2).  The rows are
    independent and walked ``_HUNT_ROWS`` at a time, which bounds the
    correlation intermediate and changes no result."""
    parts = [_hunt_planes_rows(cfg, windows[i:i + _HUNT_ROWS], col_offset,
                               frac)
             for i in range(0, windows.shape[0], _HUNT_ROWS)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _hunt(cfg: ModemConfig, windows):
    """Find the (phase, lag) correlation peak of complex windows
    [N, cyc, 2*n_sym] (the batch paths hunt planes).  Returns (lag,
    phase_idx, peak, frac): ``frac`` is the parabolic sub-sample offset
    with ``cfg.frac_timing``, else zero, as in the JAX package."""
    planes = torch.view_as_real(windows).permute(0, 1, 3, 2)
    if cfg.frac_timing:
        return _hunt_planes(cfg, planes, frac=True)
    lag, phase_idx, peak = _hunt_planes(cfg, planes)
    return lag, phase_idx, peak, torch.zeros_like(peak)


def _extract_packet(cfg: ModemConfig, windows, lag, phase_idx, frac):
    """Extract the aligned packets [N, pkt_window] from complex windows
    [N, cyc, 2*n_sym].

    A (lag, phase) pair addresses absolute sample
    t0 = (lag - L//2)*cyc + phase of the time-ordered filtered stream
    s2[n*cyc + c] = windows[c, n]; the packet is the stride-``cyc`` comb
    from t0, zero outside the stream.  With ``cfg.frac_timing`` each comb
    sample is blended with its neighbour one sample later (frac >= 0) or
    earlier by |frac|: a 2-tap fractional delay; without, the comb is the
    packet (the batch paths extract planes).
    """
    cyc, off = cfg.cycles, cfg.eq_length // 2
    N = windows.shape[0]
    s2 = windows.transpose(-1, -2).reshape(N, -1)
    T = s2.shape[-1]
    base = ((lag.long() - off) * cyc + phase_idx.long())[:, None] + cyc * \
        torch.arange(cfg.pkt_window, device=windows.device)

    def comb(shift: int):
        idx = base + shift
        vals = torch.gather(s2, 1, idx.clamp(0, T - 1))
        return torch.where((idx >= 0) & (idx < T), vals, 0.0)

    grid = comb(0)
    if not cfg.frac_timing:
        return grid
    af = frac.abs().to(_F32)[:, None]
    nb = torch.where((frac >= 0)[:, None], comb(1), comb(-1))
    return grid * (1.0 - af) + nb * af


def _extract_packet_planes(cfg: ModemConfig, windows, lag, phase_idx):
    """Plane-typed packet extraction (integer timing only).

    ``windows``: [N, cyc, 2, 2*n_sym] f32.  pkt[t] =
    windows[phase_idx, :, lag - off + t]: a left pad of eq_length//2,
    a zero right pad for lags near the window's end, one gather.
    Returns [N, 2, pkt_window].
    """
    off = cfg.eq_length // 2
    pkt_len = cfg.pkt_window
    N, W = windows.shape[0], windows.shape[-1]
    dev = windows.device
    sel = windows[torch.arange(N, device=dev), phase_idx.long()]
    rpad = max(0, (cfg.symbols_per_block - 1) + pkt_len - (off + W))
    sp = torch.nn.functional.pad(sel, (off, rpad))
    idx = lag.long()[:, None] + torch.arange(pkt_len, device=dev)
    return torch.gather(sp, 2, idx[:, None].expand(N, 2, pkt_len))


# ------------------------------------------------------- the XLA path

def _preamble_f32() -> np.ndarray:
    return PREAMBLE_VALUES.astype(np.float32)


def _train_and_decode(cfg: ModemConfig, pkt):
    """Closed-form equalizer fit and one-shot decode of aligned packets
    ``pkt`` [N, pkt_window] (first preamble chip at index L//2): the LS
    fit on the preamble, ``cfg.ls_refit_iters`` decision-directed refits
    each kept only if it matches the known chips at least as often,
    the frozen filter on the data, the phase refinement.  Returns
    ``(matches, dibits, eq_error)``."""
    off = cfg.eq_length // 2
    pre = on_device(_preamble_f32, (), pkt.device)
    coeff, matches = ls_train(pkt, off, pre, cfg.eq_length, cfg.ls_reg,
                              offtap_reg=cfg.ls_offtap_reg)
    start = off + cfg.preamble_length
    c_pre = window_matrix(pkt, off, cfg.preamble_length, cfg.eq_length)

    def chip_matches(c):
        val = torch.matmul(c_pre, c[..., None])[..., 0]
        return ((val.real * pre) > 0).sum(-1)

    for _ in range(cfg.ls_refit_iters):
        cand = ls_refit(pkt, start, coeff, cfg.frame_symbols,
                        offtap_reg=cfg.ls_offtap_reg_refit,
                        n_fit=cfg.ls_refit_symbols)
        keep = chip_matches(cand) >= chip_matches(coeff)
        coeff = torch.where(keep[..., None], cand, coeff)
    raw = ls_decode(pkt, start, coeff, cfg.frame_symbols)
    _, dibits, err = phase_refine(raw, iterations=cfg.phase_refine_iters)
    return matches, dibits, err


def prod_rx_backend(cfg: ModemConfig, decim_prev, filtered, *,
                    descramble: bool = True):
    """Post-filter demodulation: decimate -> hunt -> CFO -> equalize.

    ``filtered``: [..., frame_size] complex matched-filter output;
    ``decim_prev``: [..., cycles, n_sym] the previous block's decimated
    phases.  Returns ``(decim_cur, ProdRxOut)`` with [...] leaves.  Plain
    PyTorch throughout: the plain hunt (``cfg.hunt_dtype`` operands,
    true f32 sums), the extraction (blended with ``cfg.frac_timing``),
    the energy gate, the bf16 CFO DFT (``estimate_cfo``), de-rotation,
    ``_train_and_decode`` and the per-packet descramble.
    """
    n_sym, cyc = cfg.symbols_per_block, cfg.cycles
    off, P = cfg.eq_length // 2, cfg.preamble_length
    lead = filtered.shape[:-1]
    decim_cur = filtered.reshape(*lead, n_sym, cyc).transpose(-1, -2)
    windows = torch.cat([decim_prev, decim_cur], dim=-1).reshape(
        -1, cyc, 2 * n_sym)
    lag, phase_idx, peak, frac = _hunt(cfg, windows)
    pkt = _extract_packet(cfg, windows, lag, phase_idx, frac)

    # energy gate on the window energy at the peak
    chips = pkt[:, off:off + P]
    energy = (chips.real ** 2 + chips.imag ** 2).sum(-1)
    gated = peak > energy * cfg.effective_peak_gate
    pre = on_device(_preamble_f32, (), pkt.device)
    cfo_hz, _ = estimate_cfo(chips, pre, cfg.rs, nfft=cfg.cfo_nfft)
    cfo_hz = torch.where(gated, cfo_hz, 0.0)

    # de-rotation anchored at the preamble start (index off)
    k = torch.arange(cfg.pkt_window, dtype=_F32, device=pkt.device) - off
    ang = (cfo_hz * (-2.0 * np.pi / cfg.rs))[:, None] * k
    pkt = pkt * torch.complex(torch.cos(ang), torch.sin(ang))

    matches, dibits, eq_error = _train_and_decode(cfg, pkt)
    if descramble:                      # per-packet keystream reset
        dibits, _ = scramble_dibits(dibits, 0)
    out = ProdRxOut(
        valid=gated & (matches > cfg.match_threshold),
        bits=dibits_to_bits(dibits), matches=matches, lag=lag,
        timing_phase=phase_idx, peak=peak, energy=energy, cfo_hz=cfo_hz,
        eq_error=eq_error)
    return (decim_cur.contiguous(),
            ProdRxOut(*(x.reshape((*lead, *x.shape[1:])) for x in out)))


def prod_rx_frame(cfg: ModemConfig, state: ProdRxState, pcm, *,
                  descramble: bool = True):
    """Demodulate one frame_size block on the XLA path: ``pcm``
    [..., frame_size] (int16 or float PCM) with ``state`` of leading
    shape [...].  Returns ``(state, ProdRxOut)``; runs on the state's
    device."""
    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    x = _frames_on(state, pcm).float() / cfg.tx_amplitude
    raw, phase = mix_block(x, state.phase, -cfg.center, cfg.fs)
    filtered, fir_tail = fir_block(taps, cfg.fir_gain, state.fir_tail, raw)
    decim_cur, out = prod_rx_backend(cfg, state.decim_prev, filtered,
                                     descramble=descramble)
    return ProdRxState(phase=phase, fir_tail=fir_tail,
                       decim_prev=decim_cur), out


def prod_rx_stream(cfg: ModemConfig, state: ProdRxState, pcm_frames, *,
                   descramble: bool = True):
    """Stream demod on the XLA path over ``pcm_frames`` [n_frames, ...,
    frame_size], one block at a time (``lax.scan`` in the JAX package).
    Returns ``(state, ProdRxOut)`` with [n_frames, ...] leaves."""
    outs = []
    for pcm in pcm_frames:
        state, out = prod_rx_frame(cfg, state, pcm, descramble=descramble)
        outs.append(out)
    return state, ProdRxOut(*(torch.stack(xs) for xs in zip(*outs)))


# ------------------------------------------------------ entry points

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


def _is_plane_state(state) -> bool:
    if isinstance(state, ProdRxState):
        return False
    if not (isinstance(state, tuple) and len(state) == 5
            and all(isinstance(t, torch.Tensor) for t in state)):
        raise TypeError("state must be a ProdRxState or the 5-tuple of "
                        "prod_rx_init_planes")
    return True


def _frames_on(state, pcm_frames) -> torch.Tensor:
    """The PCM on the device the state lies on."""
    return pcm_frames.to(state[0].device)


def prod_rx_batch(cfg: ModemConfig, state, pcm_frames, *,
                  descramble: bool = True, block_channels: int = 128,
                  decode_block_channels: int | None = None,
                  segs_per_chunk: int = 2,
                  fuse_extract: bool = True, fuse_hunt: bool = True,
                  fuse_frontend: bool = False, interpret: bool = False):
    """Block-parallel batched demod of [B, C, frame_size] int16 frames.

    ``state`` is a :class:`ProdRxState` or the plane tuple of
    :func:`prod_rx_init_planes` (or what a previous call returned); the
    same type comes back.  Returns ``(state, ProdRxOut)`` with
    [B, C, ...] leaves.  Runs on the state's device.

      * ``fuse_frontend=True``: the one-kernel path
        (``ops.fused_rx.fused_rx_block``);
      * else the per-row front-end (``ops.frontend.fused_frontend_decim``)
        and, by ``fuse_hunt`` / ``fuse_extract``:
        ``fused_hunt_decode_decim`` on transposed planes (both set), the
        plain hunt + ``fused_decode_extract`` (``fuse_hunt=False``), or
        the plain hunt and extraction + ``fused_decode``
        (``fuse_extract=False``).  The last two read the row-major f32
        planes whatever ``cfg.decim_dtype`` says, and need a
        ``ProdRxState``.

    ``block_channels``, ``decode_block_channels``, ``segs_per_chunk`` and
    ``interpret`` only size the TPU kernels; they are accepted and
    ignored so that a call written for the JAX package runs unchanged.
    """
    if cfg.frac_timing and (fuse_hunt or fuse_extract or fuse_frontend):
        raise ValueError(
            "cfg.frac_timing=True is not supported by the fused batch "
            "paths (integer-timing extraction only); set "
            "frac_timing=False")
    plane_state = _is_plane_state(state)
    pcm_frames = _frames_on(state, pcm_frames)
    B, C = pcm_frames.shape[0], pcm_frames.shape[1]
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    n_sym = cfg.symbols_per_block
    inv_scale = 1.0 / cfg.tx_amplitude

    if plane_state:
        if not (fuse_extract and fuse_hunt):
            raise TypeError(
                "plane-typed state (prod_rx_init_planes) requires the "
                "fully fused path (fuse_extract=True, fuse_hunt=True); "
                "pass a ProdRxState for the unfused paths")
        p0r, p0i, tail0_r, tail0_i, dprev0_t_in = state
    else:
        p0r, p0i, tail0_r, tail0_i = (
            t.contiguous() for t in (state.phase.real, state.phase.imag,
                                     state.fir_tail.real,
                                     state.fir_tail.imag))
        dprev0_t_in = None

    if fuse_frontend:
        if not (fuse_extract and fuse_hunt):
            raise ValueError(
                "fuse_frontend requires fuse_extract and fuse_hunt")
        dprev0_t = (dprev0_t_in if plane_state
                    else _planes_t(state.decim_prev))
        dec, dlast, (fr, fi, ftr, fti) = fused_rx_block(
            cfg, pcm_frames, p0r, p0i, tail0_r, tail0_i, dprev0_t,
            descramble=descramble)
        out = _decode_out(cfg, dec, dec["lag"], dec["phase_idx"],
                          dec["peak"])
        out = ProdRxOut(*(x.reshape(B, C, *x.shape[1:]) for x in out))
        if plane_state:
            return (fr, fi, ftr, fti, dlast), out
        return ProdRxState(phase=torch.complex(fr, fi),
                           fir_tail=torch.complex(ftr, fti),
                           decim_prev=_complex_planes(dlast)), out

    # adv^b for b in [0, B], uploaded once per (config, B, device)
    advs, adv = _advances(cfg, B, pcm_frames.device)

    # phases[b] = phase_0 * adv^b  (planes [B, C])
    ar, ai = adv[0][:, None], adv[1][:, None]
    ph_r = p0r[None, :] * ar - p0i[None, :] * ai
    ph_i = p0r[None, :] * ai + p0i[None, :] * ar

    # tails[b] = last `halo` downmixed samples of raw block b-1
    # (tails[0] = carried state), in scaled units
    x_t = pcm_frames[:, :, n - halo:].float() * inv_scale
    tl_r, tl_i = downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                              ph_r[..., None], ph_i[..., None])
    tails_r = torch.cat([tail0_r[None], tl_r[:-1]], 0)
    tails_i = torch.cat([tail0_i[None], tl_i[:-1]], 0)
    # copies, so that the state does not keep the whole batch alive
    fin_tr, fin_ti = tl_r[-1].clone(), tl_i[-1].clone()

    # final phase (closed form)
    fr = p0r * float(advs.real[B]) - p0i * float(advs.imag[B])
    fi = p0r * float(advs.imag[B]) + p0i * float(advs.real[B])
    mag = torch.sqrt(fr * fr + fi * fi)
    fr, fi = fr / mag, fi / mag

    # ---- one batched front-end over all B*C (block, channel) rows ----
    N = B * C
    rows = (pcm_frames.reshape(N, n), ph_r.reshape(N), ph_i.reshape(N),
            tails_r.reshape(N, halo), tails_i.reshape(N, halo))

    if fuse_extract and fuse_hunt:
        dcur_t = fused_frontend_decim(cfg, *rows, transposed=True)[0]
        dprev0_t = (dprev0_t_in if plane_state
                    else _planes_t(state.decim_prev))
        dprev0_t = dprev0_t.to(dcur_t.dtype).contiguous()
        dec = fused_hunt_decode_decim(cfg, dprev0_t, dcur_t, channels=C,
                                      descramble=descramble)
        out = _decode_out(cfg, dec, dec["lag"], dec["phase_idx"],
                          dec["peak"])
        out = ProdRxOut(*(x.reshape(B, C, *x.shape[1:]) for x in out))
        dlast = dcur_t[:, :, (B - 1) * C:].clone()
        if plane_state:
            return (fr, fi, fin_tr, fin_ti, dlast), out
        return ProdRxState(phase=torch.complex(fr, fi),
                           fir_tail=torch.complex(fin_tr, fin_ti),
                           decim_prev=_complex_planes(dlast)), out

    dcur = fused_frontend_decim(cfg, *rows)[0]
    decim = dcur.reshape(B, C, cfg.cycles, 2, n_sym)

    # hunt windows: [prev | cur] along the symbol axis
    dprev0 = torch.stack([state.decim_prev.real, state.decim_prev.imag],
                         dim=1)                             # [C, 2, ...]
    dprev0 = dprev0.transpose(1, 2)[None]                   # [1, C, cyc, 2, .]
    dprev = torch.cat([dprev0, decim[:-1]], dim=0)

    if fuse_extract:
        # one padded windows array serves both the hunt (reads at a
        # column offset) and the kernel's extraction (packets start at
        # `lag`): [off | prev | cur | rpad]
        off = cfg.eq_length // 2
        need = (n_sym - 1) + cfg.pkt_window
        wp = -(-max(need, off + 2 * n_sym) // 128) * 128
        zl = decim.new_zeros((B, C, cfg.cycles, 2, off))
        zr_ = decim.new_zeros((B, C, cfg.cycles, 2, wp - off - 2 * n_sym))
        windows = torch.cat([zl, dprev, decim, zr_], -1).reshape(
            N, cfg.cycles, 2, wp)
        lag, phase_idx, peak = _hunt_planes(cfg, windows, col_offset=off)
        dec = fused_decode_extract(cfg, windows, lag, phase_idx, peak,
                                   descramble=descramble)
    else:
        windows = torch.cat([dprev, decim], dim=-1).reshape(
            N, cfg.cycles, 2, 2 * n_sym)
        lag, phase_idx, peak = _hunt_planes(cfg, windows)
        pkt = _extract_packet_planes(cfg, windows, lag, phase_idx)
        dec = fused_decode(cfg, pkt[:, 0].contiguous(),
                           pkt[:, 1].contiguous(), peak,
                           descramble=descramble)
    out = _decode_out(cfg, dec, lag, phase_idx, peak)
    out = ProdRxOut(*(x.reshape(B, C, *x.shape[1:]) for x in out))
    final = ProdRxState(
        phase=torch.complex(fr, fi),
        fir_tail=torch.complex(fin_tr, fin_ti),
        decim_prev=torch.complex(decim[-1, :, :, 0, :].contiguous(),
                                 decim[-1, :, :, 1, :].contiguous()))
    return final, out


def prod_rx_stream_pallas(cfg: ModemConfig, state: ProdRxState,
                          pcm_frames, *, descramble: bool = True,
                          block_channels: int = 256,
                          decode_block_channels: int = 64,
                          fuse_decode: bool = True,
                          interpret: bool = False):
    """Batched stream demod, one block at a time.

    ``state``: channel-batched ProdRxState ([C] leading axis);
    ``pcm_frames``: [n_frames, C, frame_size] int16.  Per block: the
    per-row front-end, then hunt + extraction + decode
    (``fused_hunt_decode_decim``); the carried state stays in plane
    layout on the device across the loop, with no synchronisation, and
    becomes a ProdRxState again once at the end.  Returns
    ``(state, ProdRxOut)`` with [n_frames, C, ...] leaves.

    With ``fuse_decode=False`` or ``cfg.frac_timing`` the body is the
    reference-structured one, carrying the complex state: the full-rate
    front-end (``fused_frontend``) and then either the XLA back end
    (``prod_rx_backend``, ``fuse_decode=False``) or the plain hunt with
    its parabolic sub-sample offset, the blended extraction and
    ``fused_decode``.

    ``block_channels``, ``decode_block_channels`` and ``interpret`` only
    size the TPU kernels; accepted and ignored.
    """
    if not isinstance(state, ProdRxState):
        raise TypeError("prod_rx_stream_pallas takes a ProdRxState")
    pcm_frames = _frames_on(state, pcm_frames)
    if not fuse_decode:
        return _stream_full_rate(cfg, state, pcm_frames, functools.partial(
            prod_rx_backend, cfg, descramble=descramble))
    if cfg.frac_timing:
        return _stream_full_rate(cfg, state, pcm_frames, functools.partial(
            _fused_decode_backend, cfg, descramble=descramble))
    C = pcm_frames.shape[1]
    pr, pi_, tr, ti, dprev_t = state_to_planes(cfg, state)
    outs = []
    for pcm in pcm_frames:
        dcur_t, tr, ti, pr, pi_ = fused_frontend_decim(
            cfg, pcm, pr, pi_, tr, ti, transposed=True)
        dec = fused_hunt_decode_decim(cfg, dprev_t, dcur_t, channels=C,
                                      descramble=descramble)
        outs.append(_decode_out(cfg, dec, dec["lag"], dec["phase_idx"],
                                dec["peak"]))
        dprev_t = dcur_t
    outs = ProdRxOut(*(torch.stack(xs) for xs in zip(*outs)))
    return planes_to_state((pr, pi_, tr, ti, dprev_t)), outs


def _fused_decode_backend(cfg: ModemConfig, dprev, filtered, *,
                          descramble: bool):
    """The fractional-timing back end of :func:`prod_rx_stream_pallas`
    (``rx_production.py:578-593`` of the JAX package): the plain hunt
    with its sub-sample offset, the blended extraction and
    ``fused_decode``.  Returns ``(decim_cur, ProdRxOut)``."""
    n_sym, cyc = cfg.symbols_per_block, cfg.cycles
    dcur = filtered.reshape(-1, n_sym, cyc).transpose(-1, -2)
    windows = torch.cat([dprev, dcur], dim=-1)
    lag, phase_idx, peak, frac = _hunt(cfg, windows)
    pkt = _extract_packet(cfg, windows, lag, phase_idx, frac)
    dec = fused_decode(cfg, pkt.real.contiguous(), pkt.imag.contiguous(),
                       peak, descramble=descramble)
    return dcur.contiguous(), _decode_out(cfg, dec, lag, phase_idx, peak)


def _stream_full_rate(cfg: ModemConfig, state: ProdRxState, pcm_frames,
                      backend):
    """The complex-carry body of :func:`prod_rx_stream_pallas`
    (``rx_production.py:565-601`` of the JAX package): per block the
    full-rate front-end, then ``backend(decim_prev, filtered) ->
    (decim_cur, ProdRxOut)``.  Every per-block intermediate dies with its
    iteration; only the previous block's phases are carried."""
    ph_r, ph_i, tl_r, tl_i = (
        t.contiguous() for t in (state.phase.real, state.phase.imag,
                                 state.fir_tail.real, state.fir_tail.imag))
    dprev = state.decim_prev
    outs = []
    for pcm in pcm_frames:
        fr, fi, tl_r, tl_i, ph_r, ph_i = fused_frontend(
            cfg, pcm, ph_r, ph_i, tl_r, tl_i)
        dprev, out = backend(dprev, torch.complex(fr, fi))
        outs.append(out)
    outs = ProdRxOut(*(torch.stack(xs) for xs in zip(*outs)))
    return ProdRxState(phase=torch.complex(ph_r, ph_i),
                       fir_tail=torch.complex(tl_r, tl_i),
                       decim_prev=dprev), outs


def prod_rx_stream_superstep(cfg: ModemConfig, state, pcm_frames, *,
                             superstep: int = 4, descramble: bool = True,
                             block_channels: int = 128,
                             decode_block_channels: int | None = None,
                             fuse_frontend: bool = False,
                             interpret: bool = False):
    """Streaming demod at batch-mode throughput: a loop of
    :func:`prod_rx_batch` over groups of ``superstep`` blocks, so a
    stream that arrives K blocks at a time runs each arrival as one
    dispatch (latency bounded at K blocks).

    ``state`` may be a ProdRxState or the plane tuple; the same type is
    returned.  ``pcm_frames``: [n_blocks, C, frame_size] int16 with
    n_blocks a multiple of ``superstep``.  ``block_channels``,
    ``decode_block_channels`` and ``interpret`` are accepted and
    ignored.
    """
    B = pcm_frames.shape[0]
    if B % superstep:
        raise ValueError(f"n_blocks ({B}) not a multiple of "
                         f"superstep ({superstep})")
    plane_state = _is_plane_state(state)
    st = state if plane_state else state_to_planes(cfg, state)
    outs = []
    for i in range(0, B, superstep):
        st, out = prod_rx_batch(cfg, st, pcm_frames[i:i + superstep],
                                descramble=descramble,
                                fuse_frontend=fuse_frontend)
        outs.append(out)
    outs = ProdRxOut(*(torch.cat(xs) for xs in zip(*outs)))
    return (st if plane_state else planes_to_state(st)), outs


def make_prod_rx_fn(cfg: ModemConfig, *, descramble: bool = True,
                    batched: bool = False, pallas: bool = False):
    """``fn(state, pcm_frames) -> (state, ProdRxOut)`` for the streaming
    RX.  ``pallas=True``: :func:`prod_rx_stream_pallas`.  Else the XLA
    path :func:`prod_rx_stream` on ``pcm_frames`` [n_frames, frame_size]
    and an unbatched state, or with ``batched`` (``vmap`` in the JAX
    package) a state of leading shape [C] and ``pcm_frames`` [C,
    n_frames, frame_size], outputs [C, n_frames, ...].  PyTorch runs
    eagerly, so there is nothing to jit."""
    if pallas:
        def fn(state, pcm_frames):
            return prod_rx_stream_pallas(cfg, state, pcm_frames,
                                         descramble=descramble)
        return fn

    def fn(state, pcm_frames):
        if not batched:
            return prod_rx_stream(cfg, state, pcm_frames,
                                  descramble=descramble)
        state, out = prod_rx_stream(cfg, state, pcm_frames.transpose(0, 1),
                                    descramble=descramble)
        return state, ProdRxOut(*(x.transpose(0, 1) for x in out))
    return fn
