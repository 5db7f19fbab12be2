"""Carrier mixing tables and the closed-form FIR-tail carry-out.

Counterpart of ``singlecarrier_tpu/dsp/mixer.py``: the per-block ramp
table is computed once in float64 on the host, so the mixer is one
complex multiply per sample against a constant table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
