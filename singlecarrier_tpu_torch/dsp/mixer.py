"""Carrier mixing tables and the closed-form FIR-tail carry-out.

Counterpart of ``singlecarrier_tpu/dsp/mixer.py``: the per-block ramp
table is computed once in float64 on the host, so the mixer is one
complex multiply per sample against a constant table; the carried state
is one unit phasor per stream, renormalized per block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import on_device, resolve_device


def mixer_init_phase(batch_shape=(), device=None) -> torch.Tensor:
    """Initial unit phasor 1+0j (qpsk.c:375, 427), complex64, on the card
    unless ``device`` says otherwise."""
    return torch.ones(tuple(batch_shape), dtype=torch.complex64,
                      device=resolve_device(device))


@functools.lru_cache(maxsize=32)
def mixer_table(freq_hz: float, fs: float, n: int) -> np.ndarray:
    """Relative ramp ``exp(j*2*pi*freq/fs*(arange(n)+1))`` in complex64.

    Computed in float64 so the angle never loses precision to float32
    argument reduction.  Index n-1 is the per-block phase advance.
    """
    w = 2.0 * np.pi * freq_hz / fs
    return np.exp(1j * w * (np.arange(1, n + 1))).astype(np.complex64)


def downmix_tail(center: float, fs: float, n: int, halo: int,
                 x_t: torch.Tensor, ph_r: torch.Tensor,
                 ph_i: torch.Tensor):
    """Downmixed FIR-tail planes from RAW tail samples (closed form).

    ``x_t``: [..., halo] f32 last-halo raw samples already scaled to
    matched-filter units; ``ph_r``/``ph_i``: phase planes at the START
    of the block the samples came from, broadcastable against x_t.
    The single definition of the carry-out: the operation order is the
    JAX package's, so both packages carry bit-identical tails.
    """
    tr, ti = tail_table(center, fs, n, halo, x_t.device)
    return (x_t * (ph_r * tr - ph_i * ti),
            x_t * (ph_r * ti + ph_i * tr))


@functools.lru_cache(maxsize=32)
def tail_table(center: float, fs: float, n: int, halo: int, device):
    """(real, imag) planes of the RX mixer table's last ``halo`` entries
    on ``device``, uploaded once: a per-block streaming loop must not
    wait on host copies."""
    table = mixer_table(-center, fs, n)
    return (torch.from_numpy(table.real[n - halo:].copy()).to(device),
            torch.from_numpy(table.imag[n - halo:].copy()).to(device))


def mix_block(x: torch.Tensor, phase: torch.Tensor, freq_hz: float,
              fs: float):
    """Mix a block; returns ``(y, new_phase)``.

    ``x``: [..., n] real (PCM already scaled) or complex block;
    ``phase``: [...] carried unit phasor; ``freq_hz`` negative to
    downmix.  ``y = x * (phase * table)`` and the phase advanced by the
    table's last entry, renormalized (qpsk.c:139-147, 301-306).
    """
    n = x.shape[-1]
    table = on_device(mixer_table, (float(freq_hz), float(fs), int(n)),
                      x.device)
    y = x * (phase[..., None] * table)
    new_phase = phase * table[n - 1]
    return y, new_phase / new_phase.abs()
