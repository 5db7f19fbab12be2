"""DFT table and the FFT-based carrier-frequency-offset search.

Counterpart of ``singlecarrier_tpu/dsp/fftops.py``.  The received
preamble chips are r[k] ~ a p[k] exp(j(2 pi df k / rs + phi));
multiplying by the known +/-1 chips leaves a tone whose zero-padded
spectrum peak, refined by a parabola through its neighbours, is the
offset (unambiguous within +/- rs/2).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import require_true_f32


@functools.lru_cache(maxsize=8)
def dft_matrix(p: int, nfft: int) -> np.ndarray:
    """[p, nfft] DFT analysis matrix (host, complex64)."""
    k = np.arange(p)[:, None]
    f = np.arange(nfft)[None, :]
    return np.exp(-2j * np.pi * k * f / nfft).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _bf16_dft_planes(p: int, nfft: int, device):
    """The DFT table's planes rounded to bf16, held as f32 on ``device``."""
    wm = dft_matrix(p, nfft)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device).to(
        torch.bfloat16).float() for a in (wm.real, wm.imag))


def _tone_power(tone: torch.Tensor, nfft: int, method: str) -> torch.Tensor:
    """Power spectrum [..., nfft] of the zero-padded tone.

    ``"dft"`` is the JAX package's bf16 product with f32 accumulation:
    the operands are rounded to bf16 and multiplied in true f32 (their
    products are exact; a bf16 ``torch.matmul`` would round its sums).
    """
    if method == "dft":
        wr, wi = _bf16_dft_planes(int(tone.shape[-1]), int(nfft),
                                  tone.device)
        tr = tone.real.to(torch.bfloat16).float()
        ti = tone.imag.to(torch.bfloat16).float()
        require_true_f32(tr)
        sr = torch.matmul(tr, wr) - torch.matmul(ti, wi)
        si = torch.matmul(tr, wi) + torch.matmul(ti, wr)
        return sr * sr + si * si
    spec = torch.fft.fft(tone, n=nfft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def estimate_cfo(chips: torch.Tensor, pn: torch.Tensor, symbol_rate: float,
                 *, nfft: int = 512, method: str = "dft"):
    """Carrier offset (Hz) from received preamble chips.

    ``chips``: [..., P] complex at the symbol rate; ``pn``: [P] real
    +/-1 chips.  Returns ``(cfo_hz, peak_power)``, both [...] f32.
    """
    power = _tone_power(chips * pn, nfft, method)
    k = torch.argmax(power, dim=-1)                  # first maximum

    def at(i):
        return torch.gather(power, -1, i[..., None])[..., 0]

    pm, p0, pp = at((k - 1) % nfft), at(k), at((k + 1) % nfft)
    denom = pm - 2.0 * p0 + pp
    delta = torch.where(denom.abs() > 1e-20, 0.5 * (pm - pp) / denom, 0.0)
    kf = k.float() + delta
    kf = torch.where(kf > nfft / 2, kf - nfft, kf)
    return kf * (symbol_rate / nfft), p0


def wipeoff_rotation(n_sym: int, cfo_hz: torch.Tensor,
                     symbol_rate: float) -> torch.Tensor:
    """Rotation ``exp(-j 2 pi cfo k / rs)`` [..., n_sym] complex64 that
    de-rotates symbols after a CFO estimate."""
    k = torch.arange(n_sym, dtype=torch.float32, device=cfo_hz.device)
    ang = -2.0 * np.pi * cfo_hz[..., None] / symbol_rate * k
    return torch.complex(torch.cos(ang), torch.sin(ang))
