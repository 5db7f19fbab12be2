"""QPSK demodulator, the reference-faithful RX chain
(``singlecarrier_tpu/modem/rx.py``).

The reference RX path (src/qpsk.c:133-239): downmix -> RRC matched
filter -> decimate-by-cycles -> 128-lag preamble correlation hunt ->
square-root-Kalman-trained equalizer over the 128 known chips ->
threshold detect -> decision-directed slicing of the data symbols ->
descramble.  Every reference static is a field of ``RxState``, batched
over any leading (channel) shape; a frame is one call of
:func:`rx_frame`, a stream a Python loop of them.  The FIR and the
correlation are products over the whole batch; the one serial core is
the 159-step Kalman/equalizer recursion, a loop of batched tensor
operations over windows gathered before it.

Faithful-mode quirks replicated (SURVEY.md section 2):
 * the 2-frame latency through the input/decimated double buffers
   (qpsk.c:143-144, 160-161): the hunt window is the frame received two
   blocks ago;
 * the hunt searches only lags 0..127 of the 2-frame symbol window
   (qpsk.c:176-183), with the non-conjugated correlation (qpsk.c:92);
 * ``rx_timing`` is overwritten with the sync *symbol index* on detect
   (qpsk.c:219) and then used as a sample-phase decimation offset into
   the combined [filtered prev | raw current] buffer (qpsk.c:161): reads
   past the filtered half land in raw undecimated samples, as in the C;
 * the miss branch keeps running the decision-directed equalizer at
   ``rx_timing`` and accumulates an EOF cost (qpsk.c:225-236);
 * the vestigial hunt/process state variable is carried but never read
   (qpsk.c:217, 234; SURVEY.md quirk #5);
 * the bits are laid out ``[dibit & 1, dibit >> 1]`` per symbol
   (qpsk.c:211-214), not as ``rx_production.dibits_to_bits``.

The JAX package slices its windows with ``lax.dynamic_slice_in_dim``,
which counts a negative start from the end and then clamps it to
``[0, n - size]``; :func:`_window_starts` does the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..adaptive.blocked_rls import blocked_eq_init, data_block, train_block
from ..adaptive.equalizer import data_step, eq_init, train_step
from ..config import ModemConfig
from ..constants import PREAMBLE_TABLE, PREAMBLE_VALUES, rrc_taps
from ..device import on_device, resolve_device
from ..dsp.correlate import preamble_correlate, window_energy
from ..dsp.decimate import decimate_at
from ..dsp.fir import fir_block, fir_init_state
from ..dsp.mixer import mix_block, mixer_init_phase
from ..scramble import scramble_dibits

HUNT = 0
PROCESS = 1


class RxState(NamedTuple):
    """Per-channel demodulator state: the reference statics of SURVEY.md
    section 2 -- phase (qpsk.c:50), fir_tail (qpsk.c:40 via fir.c:30-34),
    raw_prev / decim_prev (the double buffers, qpsk.c:41-42), rx_timing
    (qpsk.c:53), scramble_offset (scramble.c:42), sm_state (qpsk.c:37)."""
    phase: torch.Tensor            # [..] c64 downmix phasor
    fir_tail: torch.Tensor         # [.., ntaps-1] c64 matched-filter halo
    raw_prev: torch.Tensor         # [.., frame_size] c64 raw downmixed prev
    decim_prev: torch.Tensor       # [.., symbols_per_block] c64 prev symbols
    rx_timing: torch.Tensor        # [..] i32 decimation offset / sync index
    scramble_offset: torch.Tensor  # [..] i32 RX keystream position (dibits)
    sm_state: torch.Tensor         # [..] i32 vestigial hunt/process flag


class RxOut(NamedTuple):
    """Per-frame outputs (the reference's return, printf stats and bits
    buffer, qpsk.c:196-238)."""
    valid: torch.Tensor       # [..] bool frame detected
    bits: torch.Tensor        # [.., data_symbols*2] u8, [IQ,...] layout
    matches: torch.Tensor     # [..] i32 trained-chip sign matches (of 128)
    max_index: torch.Tensor   # [..] i32 correlation peak lag
    max_value: torch.Tensor   # [..] f32 correlation peak power
    mean: torch.Tensor        # [..] f32 window energy at the peak
    eof_cost: torch.Tensor    # [..] f32 miss-branch accumulated error


def rx_init(cfg: ModemConfig, batch_shape=(), device=None) -> RxState:
    """The reset state (qpsk.c:370-380), on the card unless ``device``
    says otherwise."""
    dev = resolve_device(device)
    batch_shape = tuple(batch_shape)
    c64 = dict(dtype=torch.complex64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return RxState(
        phase=mixer_init_phase(batch_shape, dev),
        fir_tail=fir_init_state(cfg.ntaps, batch_shape, device=dev),
        raw_prev=torch.zeros((*batch_shape, cfg.frame_size), **c64),
        decim_prev=torch.zeros((*batch_shape, cfg.symbols_per_block), **c64),
        rx_timing=torch.full(batch_shape, cfg.fine_timing_offset, **i32),
        scramble_offset=torch.zeros(batch_shape, **i32),
        sm_state=torch.full(batch_shape, HUNT, **i32))


def _window_starts(start: torch.Tensor, count: int, size: int,
                   n: int) -> torch.Tensor:
    """[.., count] starts ``start + t`` of ``size``-long windows in an
    ``n``-long buffer, as ``lax.dynamic_slice_in_dim`` takes them: a
    negative start counts from the end, then clamps to [0, n - size]."""
    s = start.to(torch.int64)[..., None] + torch.arange(
        count, device=start.device)
    return torch.where(s < 0, s + n, s).clamp(0, n - size)


def _gather_windows(symbols: torch.Tensor, starts: torch.Tensor,
                    L: int) -> torch.Tensor:
    """[.., count, L] windows ``symbols[.., s : s + L]`` at ``starts``
    [.., count]."""
    idx = starts[..., None] + torch.arange(L, device=starts.device)
    flat = idx.reshape(*idx.shape[:-2], -1)
    return torch.gather(symbols, -1, flat).reshape(idx.shape)


def _padded_refs(P: int, n: int) -> np.ndarray:
    """[n] f32: the P real preamble chips, then zeros."""
    refs = np.zeros(n, np.float32)
    refs[:P] = PREAMBLE_VALUES[:P]
    return refs


def _equalize_and_slice(cfg: ModemConfig, symbols, max_index, rx_timing):
    """Training loop + data loop (qpsk.c:186-236) over [..] channels.

    ``symbols``: [.., n] the 2-frame decimated window.  Trains over the
    128 chips at ``max_index`` counting sign matches (qpsk.c:111-123),
    then slices the data symbols at the sync position on a hit or at
    ``rx_timing`` on a miss (qpsk.c:206-236).  The equalizer starts
    from kalman_reset each frame (qpsk.c:186).  Returns ``(matches,
    dibits [.., D], eof_cost)``.
    """
    L, E, q = cfg.eq_length, cfg.kalman_E, cfg.kalman_q
    P, D = cfg.preamble_length, cfg.data_symbols
    n = symbols.shape[-1]
    lead = symbols.shape[:-1]
    pre = [float(v) for v in PREAMBLE_VALUES[:P]]

    wins = _gather_windows(symbols, _window_starts(max_index, P, L, n), L)
    eq = eq_init(L, lead, symbols.device)
    errs = []
    for t in range(P):
        eq, err = train_step(eq, wins[..., t, :], pre[t], E, q)
        errs.append(err)
    # the match criterion (qpsk.c:117): real(err) * real(ref) > 0
    refs = on_device(_padded_refs, (P, P), symbols.device)
    matches = (torch.stack(errs, dim=-1) * refs > 0.0).sum(
        dim=-1, dtype=torch.int32)

    hit = matches > cfg.match_threshold
    start = torch.where(hit, max_index + P, rx_timing)
    wins = _gather_windows(symbols, _window_starts(start, D, L, n), L)
    eof_cost = torch.zeros(lead, dtype=torch.float32, device=symbols.device)
    dibits = []
    for t in range(D):
        eq, dibit, err = data_step(eq, wins[..., t, :], E, q,
                                   cfg.data_eq_error_gain)
        eof_cost = eof_cost + err
        dibits.append(dibit)
    return matches, torch.stack(dibits, dim=-1), eof_cost


def _equalize_and_slice_blocked(cfg: ModemConfig, symbols, max_index,
                                rx_timing, block_size: int):
    """Blocked variant of :func:`_equalize_and_slice` (same contract):
    the 159-step recursion becomes ceil(128/B) + ceil(D/B) frozen-
    coefficient blocks, each one batched filter and one information-form
    RLS update (``adaptive/blocked_rls.py``)."""
    L, E = cfg.eq_length, cfg.kalman_E
    P, D, B = cfg.preamble_length, cfg.data_symbols, block_size
    lam_B = float((1.0 / (1.0 + cfg.kalman_q)) ** B)
    n = symbols.shape[-1]
    lead = symbols.shape[:-1]
    dev = symbols.device

    def windows(start, count):
        """[.., count, L]: one clamped slice of count + L - 1 symbols."""
        s0 = _window_starts(start, 1, count + L - 1, n)
        return _gather_windows(
            symbols, s0 + torch.arange(count, device=dev), L)

    st = blocked_eq_init(L, E, lead, dev)
    nb_t = -(-P // B)
    pad_t = nb_t * B
    Z = windows(max_index, pad_t)
    refs = on_device(_padded_refs, (P, pad_t), dev)
    tmask = (torch.arange(pad_t, device=dev) < P).to(torch.float32)
    matches = torch.zeros(lead, dtype=torch.int32, device=dev)
    for b in range(nb_t):
        sl = slice(b * B, (b + 1) * B)
        st, m = train_block(st, Z[..., sl, :], refs[sl], tmask[sl], lam_B, E,
                            count_post=(b == 0))
        matches = matches + m

    hit = matches > cfg.match_threshold
    start = torch.where(hit, max_index + P, rx_timing)
    nb_d = -(-D // B)
    pad_d = nb_d * B
    W = windows(start, pad_d)
    dmask = (torch.arange(pad_d, device=dev) < D).to(torch.float32)
    eof_cost = torch.zeros(lead, dtype=torch.float32, device=dev)
    parts = []
    for b in range(nb_d):
        sl = slice(b * B, (b + 1) * B)
        st, dib, es = data_block(st, W[..., sl, :], dmask[sl], lam_B, E,
                                 cfg.data_eq_error_gain)
        parts.append(dib)
        eof_cost = eof_cost + es
    return matches, torch.cat(parts, dim=-1)[..., :D], eof_cost


def rx_frame(cfg: ModemConfig, state: RxState, pcm, *,
             freq_offset: float = 0.0, blocked: int = 0):
    """Demodulate one frame_size PCM block; returns ``(state, RxOut)``.

    Port of qpsk_rx_frame(in, bits) (qpsk.c:133-239) over the state's
    leading shape.  ``pcm``: [.., frame_size] int16 (or float) passband
    samples, moved to the state's device.  ``freq_offset``: the RX
    carrier offset in Hz (the reference's compile-time FOFFSET,
    qpsk.c:67).  ``blocked``: 0 is the reference-exact per-symbol Kalman
    recursion; B > 0 the blocked equalizer with B-symbol frozen blocks.
    """
    n_sym = cfg.symbols_per_block
    P = cfg.preamble_length
    taps = rrc_taps(cfg.alpha, cfg.ntaps)

    # 1. int16 -> float, downmix to baseband (qpsk.c:138-147).
    x = pcm.to(state.phase.device).float() / cfg.tx_amplitude
    raw_cur, phase = mix_block(x, state.phase, -(cfg.center) + freq_offset,
                               cfg.fs)

    # 2. Matched filter the PREVIOUS frame's raw samples (the C filters
    #    input_frame[0..N-1] after the shift, qpsk.c:143-152), the FIR
    #    halo carried across frames.
    filtered_prev, fir_tail = fir_block(taps, cfg.fir_gain, state.fir_tail,
                                        state.raw_prev)

    # 3. Decimate at rx_timing into the symbol double buffer
    #    (qpsk.c:157-162); a clobbered rx_timing reads into the raw half
    #    of [filtered prev | raw current], as the C reads past FRAME_SIZE.
    combined = torch.cat([filtered_prev, raw_cur], dim=-1)
    decim_new = decimate_at(combined, state.rx_timing, cfg.cycles, n_sym)
    symbols = torch.cat([state.decim_prev, decim_new], dim=-1)

    # 4. Preamble hunt over 128 lags (qpsk.c:176-183), the first maximum.
    corr = preamble_correlate(symbols, PREAMBLE_TABLE, P)
    max_index = torch.argmax(corr, dim=-1)
    max_value = torch.gather(corr, -1, max_index[..., None])[..., 0]
    energy = window_energy(symbols, P, P)
    mean = torch.gather(energy, -1, max_index[..., None])[..., 0]
    max_index = max_index.to(torch.int32)

    # 5. kalman_reset + train + slice (qpsk.c:186-236).
    if blocked:
        matches, dibits, eof_cost = _equalize_and_slice_blocked(
            cfg, symbols, max_index, state.rx_timing, blocked)
    else:
        matches, dibits, eof_cost = _equalize_and_slice(
            cfg, symbols, max_index, state.rx_timing)
    hit = matches > cfg.match_threshold

    # 6. Descramble: the RX LFSR advances 2 bits per data_eq call in both
    #    branches (equalizer.c:87), an XOR with the keystream's masks.
    dibits, scramble_offset = scramble_dibits(dibits, state.scramble_offset)

    # bits [IQ,IQ,...]: odd = I (dibit >> 1), even = Q (qpsk.c:211-214)
    bits = torch.stack([dibits & 1, dibits >> 1], dim=-1).reshape(
        *dibits.shape[:-1], -1).to(torch.uint8)

    # 7. The rx_timing clobber on detect (qpsk.c:219) and the vestigial
    #    hunt/process transitions (qpsk.c:217, 233-235).
    rx_timing = torch.where(hit, max_index + P,
                            state.rx_timing).to(torch.int32)
    sm_state = torch.where(
        hit, PROCESS,
        torch.where(eof_cost > cfg.eof_cost_value, HUNT, state.sm_state)
    ).to(torch.int32)

    new_state = RxState(phase=phase, fir_tail=fir_tail, raw_prev=raw_cur,
                        decim_prev=decim_new, rx_timing=rx_timing,
                        scramble_offset=scramble_offset.to(torch.int32),
                        sm_state=sm_state)
    out = RxOut(valid=hit, bits=bits, matches=matches, max_index=max_index,
                max_value=max_value, mean=mean, eof_cost=eof_cost)
    return new_state, out


def rx_stream(cfg: ModemConfig, state: RxState, pcm_frames, *,
              freq_offset: float = 0.0, blocked: int = 0):
    """Demodulate ``pcm_frames`` [n_frames, .., frame_size] one frame at
    a time (``lax.scan`` in the JAX package).  Returns ``(final_state,
    RxOut)`` with [n_frames, ..] leaves; ``blocked`` as in
    :func:`rx_frame`."""
    outs = []
    for pcm in pcm_frames:
        state, out = rx_frame(cfg, state, pcm, freq_offset=freq_offset,
                              blocked=blocked)
        outs.append(out)
    return state, RxOut(*(torch.stack(xs) for xs in zip(*outs)))


def make_rx_stream_fn(cfg: ModemConfig, *, freq_offset: float = 0.0,
                      batched: bool = False):
    """``fn(state, pcm_frames) -> (state, RxOut)``: :func:`rx_stream` on
    ``pcm_frames`` [n_frames, frame_size] and an unbatched state, or with
    ``batched`` (``vmap`` in the JAX package) a state of leading shape
    [C] and ``pcm_frames`` [C, n_frames, frame_size], outputs [C,
    n_frames, ..].  PyTorch runs eagerly, so there is nothing to jit."""
    def fn(state, pcm_frames):
        if not batched:
            return rx_stream(cfg, state, pcm_frames, freq_offset=freq_offset)
        state, out = rx_stream(cfg, state, pcm_frames.transpose(0, 1),
                               freq_offset=freq_offset)
        return state, RxOut(*(x.transpose(0, 1) for x in out))
    return fn
