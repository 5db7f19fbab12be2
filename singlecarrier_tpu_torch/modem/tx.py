"""QPSK modulator / TX chain (``singlecarrier_tpu/modem/tx.py``).

Port of the reference TX path (src/qpsk.c:251-342): Gray-mapped QPSK
symbols -> x5 zero-stuff -> RRC pulse-shaping FIR -> upmix to the
carrier -> real part -> int16 (preamble at half amplitude).  The
reference's statics (the tx_filter delay line and the carrier phasor,
qpsk.c:39, 47-48) live in an explicit ``TxState``.  The int16 cast
truncates toward zero like the C cast (qpsk.c:315-317) and saturates as
XLA's does (``device.to_int16``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModemConfig
from ..constants import PREAMBLE_TABLE, rrc_taps
from ..device import resolve_device, to_int16
from ..dsp.fir import fir_block, fir_init_state
from ..dsp.mixer import mix_block, mixer_init_phase
from ..scramble import scramble_dibits


class TxState(NamedTuple):
    fir_tail: torch.Tensor   # [.., ntaps-1] pulse-shaper delay line
    phase: torch.Tensor      # [..] carrier phasor


def tx_init(cfg: ModemConfig, batch_shape=(), device=None) -> TxState:
    """Zero delay line and unit phasor, on the card unless ``device``
    says otherwise."""
    return TxState(fir_tail=fir_init_state(cfg.ntaps, batch_shape,
                                           device=device),
                   phase=mixer_init_phase(batch_shape, device=device))


def qpsk_mod(bits: torch.Tensor) -> torch.Tensor:
    """Gray map bit pairs [..., 2n] ([IQ,IQ,...]: odd index I, even Q;
    bit 1 -> -1, 0 -> +1) to symbols I + jQ (qpsk.c:251-256)."""
    i = torch.where(bits[..., 1::2] == 1, -1.0, 1.0)
    q = torch.where(bits[..., 0::2] == 1, -1.0, 1.0)
    return torch.complex(i, q)


def qpsk_demod(symbols: torch.Tensor) -> torch.Tensor:
    """Hard QPSK decisions -> bits [..., 2n] u8, [IQ,...] layout
    (qpsk.c:268-271)."""
    i_bits = (symbols.real < 0.0).to(torch.uint8)
    q_bits = (symbols.imag < 0.0).to(torch.uint8)
    return torch.stack([q_bits, i_bits], dim=-1).reshape(
        *symbols.shape[:-1], -1)


def _shape_and_mix(cfg: ModemConfig, state: TxState, sig, amplitude):
    """Pulse-shape and upmix a zero-stuffed block; int16 PCM and state."""
    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    sig, fir_tail = fir_block(taps, cfg.fir_gain, state.fir_tail, sig)
    sig, phase = mix_block(sig, state.phase, cfg.center, cfg.fs)
    return to_int16(sig.real * amplitude), TxState(fir_tail=fir_tail,
                                                   phase=phase)


def tx_frame(cfg: ModemConfig, state: TxState, symbols: torch.Tensor,
             amplitude: float):
    """Modulate one block of symbols [..., n_sym]; returns
    ``(pcm_int16 [..., n_sym * cycles], new_state)`` (qpsk_tx_frame,
    qpsk.c:278-322).  ``amplitude``: 8192 for the preamble, 16384 for
    data (qpsk.c:313-319)."""
    n = symbols.shape[-1] * cfg.cycles
    sig = torch.zeros((*symbols.shape[:-1], n), dtype=torch.complex64,
                      device=symbols.device)
    sig[..., ::cfg.cycles] = symbols
    return _shape_and_mix(cfg, state, sig, amplitude)


def _flushed_gap(cfg: ModemConfig, state: TxState, batch_shape):
    """The inter-packet gap's zeros run through the pulse shaper, so each
    packet's last pulses reach the air (the reference writes raw zeros,
    qpsk.c:410-412, truncating them)."""
    zeros = torch.zeros((*batch_shape, cfg.inter_packet_gap),
                        dtype=torch.complex64, device=state.phase.device)
    return _shape_and_mix(cfg, state, zeros, cfg.tx_amplitude)


def tx_packet(cfg: ModemConfig, state: TxState, bits: torch.Tensor, *,
              scramble_offset=None, flush_gap: bool = False):
    """Modulate one packet: preamble + ns data frames + gap
    (qpsk.c:380-413).  ``bits``: [..., ns, data_symbols*2] in [IQ,...]
    layout, scrambled first from ``scramble_offset`` if given.  Returns
    ``(pcm [..., packet_size] int16, new_state)``."""
    dev = state.phase.device
    pre = torch.from_numpy(PREAMBLE_TABLE).to(dev).expand(
        *bits.shape[:-2], cfg.preamble_length)
    pcm_pre, state = tx_frame(cfg, state, pre, cfg.preamble_amplitude)

    if scramble_offset is not None:
        dibits = (bits[..., 1::2] << 1) | bits[..., 0::2]
        flat = dibits.reshape(*dibits.shape[:-2], -1)
        flat, _ = scramble_dibits(flat, scramble_offset)
        dibits = flat.reshape(dibits.shape)
        bits = torch.stack([dibits & 1, dibits >> 1], dim=-1).reshape(
            bits.shape)

    chunks = [pcm_pre]
    for j in range(cfg.ns):
        pcm_j, state = tx_frame(cfg, state, qpsk_mod(bits[..., j, :]),
                                cfg.tx_amplitude)
        chunks.append(pcm_j)
    if flush_gap:
        gap, state = _flushed_gap(cfg, state, bits.shape[:-2])
    else:
        gap = torch.zeros((*bits.shape[:-2], cfg.inter_packet_gap),
                          dtype=torch.int16, device=dev)
    chunks.append(gap)
    return torch.cat(chunks, dim=-1), state


def tx_stream(cfg: ModemConfig, bits, *, scramble: bool = False,
              flush_gap: bool = False, device=None) -> torch.Tensor:
    """Modulate a multi-packet stream (the reference's main TX loop,
    qpsk.c:373-415).  ``bits``: [..., n_packets, ns, data_symbols*2]
    (numpy or tensor), moved to the card unless ``device`` says
    otherwise.  With ``scramble`` each packet's payload is scrambled
    from keystream offset 0 (the per-packet reset the production RX
    undoes).  Returns int16 PCM [..., n_packets * packet_size]."""
    dev = resolve_device(device)
    bits = torch.as_tensor(bits).to(device=dev, dtype=torch.uint8)
    state = tx_init(cfg, bits.shape[:-3], device=dev)
    out = []
    for k in range(bits.shape[-3]):
        pcm, state = tx_packet(cfg, state, bits[..., k, :, :],
                               scramble_offset=0 if scramble else None,
                               flush_gap=flush_gap)
        out.append(pcm)
    return torch.cat(out, dim=-1)
