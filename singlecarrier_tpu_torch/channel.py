"""Channel impairment models (``singlecarrier_tpu/channel.py``): carrier
offset and phase, fractional delay, sample-rate drift, multipath, gain
and AWGN over real passband PCM [..., n], batched over leading dims.

Randomness comes from an explicit ``torch.Generator`` where the JAX
package takes a key; the one draw goes through :func:`_normal`.
Tensors are made on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

_F32 = torch.float32


def apply_cfo_phase(pcm: torch.Tensor, freq_hz: float, phase_rad: float,
                    fs: float, n0=0) -> torch.Tensor:
    """Carrier frequency + phase offset on real passband PCM: analytic
    signal -> rotate by exp(j(2 pi f t + phi)) -> real part.  The time
    axis t = (arange(n) + n0) / fs is f32, as in the JAX package."""
    x = pcm.to(_F32)
    t = (torch.arange(x.shape[-1], device=x.device) + n0).to(_F32) / fs
    ang = 2.0 * np.pi * freq_hz * t + phase_rad
    rot = torch.complex(torch.cos(ang), torch.sin(ang))
    return (_analytic(x) * rot).real


def _analytic(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal by FFT (one-sided spectrum doubling)."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=_F32, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(torch.fft.fft(x, dim=-1) * h, dim=-1)


def _normal(gen, shape, device) -> torch.Tensor:
    """Standard normal f32 draw: the channel's only randomness."""
    return torch.randn(shape, generator=gen, dtype=_F32, device=device)


def awgn(gen, pcm: torch.Tensor, snr_db: float, *,
         signal_power=None) -> torch.Tensor:
    """White Gaussian noise at ``snr_db`` added to float PCM.
    ``signal_power``: mean square of the signal; measured over the
    active (nonzero) samples of the whole array if not given."""
    x = pcm.to(_F32)
    if signal_power is None:
        active = (x.abs() > 0).sum().clamp(min=1)
        signal_power = (x * x).sum() / active
    noise_power = signal_power / (10.0 ** (snr_db / 10.0))
    std = torch.sqrt(torch.as_tensor(noise_power, dtype=_F32,
                                     device=x.device))
    return x + _normal(gen, x.shape, x.device) * std


def multipath(pcm: torch.Tensor, echoes) -> torch.Tensor:
    """Discrete multipath x + sum_i g_i x[n - d_i]; ``echoes``: list of
    (delay_samples, gain)."""
    x = pcm.to(_F32)
    out = x
    for d, g in echoes:
        shifted = torch.nn.functional.pad(x, (int(d), 0))[..., :x.shape[-1]]
        out = out + float(np.float32(g)) * shifted
    return out


def timing_offset(pcm: torch.Tensor, shift: int) -> torch.Tensor:
    """Integer-sample timing shift (a roll)."""
    return torch.roll(pcm.to(_F32), shift, dims=-1)


def sample_rate_offset(pcm: torch.Tensor, ppm: float, *,
                       order: int = 8) -> torch.Tensor:
    """Continuous sample-rate offset: output sample n is the input at
    t = n (1 + ppm 1e-6), by an ``order``-tap Lagrange interpolator whose
    positions and weights are computed on the host in float64; samples
    whose stencil runs off either end are zero."""
    x = pcm.to(_F32)
    n = x.shape[-1]
    m = order // 2
    pos = np.arange(n, dtype=np.float64) * (1.0 + float(ppm) * 1e-6)
    i0 = np.floor(pos).astype(np.int64)
    mu = pos - i0
    valid = (i0 >= m - 1) & (i0 + m <= n - 1)
    ic = np.clip(i0, m - 1, n - 1 - m)
    offs = np.arange(-(m - 1), m + 1)
    out = torch.zeros_like(x)
    for k in offs:
        w = np.ones(n, np.float64)
        for j in offs:
            if j != k:
                w *= (mu - j) / (k - j)
        wt = torch.from_numpy(w.astype(np.float32)).to(x.device)
        idx = torch.from_numpy(ic + k).to(x.device)
        out = out + wt * torch.index_select(x, -1, idx)
    return torch.where(torch.from_numpy(valid).to(x.device), out, 0.0)


def fractional_delay(pcm: torch.Tensor, delay: float, *,
                     ntaps: int = 33) -> torch.Tensor:
    """Fractional-sample delay by a Hamming-windowed sinc, as a
    cross-correlation summed in ascending tap order."""
    x = pcm.to(_F32)
    k = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(k - delay) * np.hamming(ntaps)
    h = (h / h.sum()).astype(np.float32)
    pad = (ntaps - 1) // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    n = x.shape[-1]
    out = torch.zeros_like(x)
    for i, hi in enumerate(h):
        out = out + float(hi) * xp[..., i:i + n]
    return out


def channel(gen, pcm, *, snr_db=None, freq_hz=0.0, phase_rad=0.0,
            delay=0.0, ppm=0.0, gain=1.0, fs: float = 8000.0,
            signal_power=None, echoes=(), device=None) -> torch.Tensor:
    """Composite impairment: CFO/phase -> delay -> drift -> multipath ->
    gain -> AWGN.  ``gen``: the ``torch.Generator`` of the noise (on the
    PCM's device; unused without ``snr_db``).  ``signal_power``: the
    reference power of the SNR before ``gain`` (scaled by gain^2 here);
    by default the active samples' mean square.  Returns f32 passband
    samples on the card unless ``device`` says otherwise (``to_int16``
    quantizes as the JAX package's ``astype(int16)``)."""
    x = torch.as_tensor(pcm).to(device=resolve_device(device), dtype=_F32)
    if freq_hz != 0.0 or phase_rad != 0.0:
        x = apply_cfo_phase(x, freq_hz, phase_rad, fs)
    if delay != 0.0:
        x = fractional_delay(x, delay)
    if ppm != 0.0:
        x = sample_rate_offset(x, ppm)
    if echoes:
        x = multipath(x, echoes)
    x = x * gain
    if snr_db is not None:
        sp = None if signal_power is None else signal_power * gain * gain
        x = awgn(gen, x, snr_db, signal_power=sp)
    return x
