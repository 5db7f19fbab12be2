"""Front-end of the one-kernel RX: int16 PCM -> decimated symbol planes.

Counterpart of the front-end stage of
``singlecarrier_tpu/ops/fused_rx.py::_fused_rx_kernel_premix``
(``fused_rx.py:166-209``), which does the math of
``ops/frontend_pallas.py::_kernel_decim_aligned``: per (block b,
channel ch) row

  * mixer phase p_b = p0 * adv^b (``adv`` tabulated in float64);
  * z = bf16(x * (pr*tr - pi*ti)), bf16(x * (pr*ti + pi*tr)) with
    x = pcm * 2^-14 and (tr, ti) the float64 mixer table;
  * u = [halo(48) | z(1880)], the halo being the carried tail for
    b = 0 and the last 48 z values of block b-1 otherwise;
  * decim[c, p, n, s] = sum_{k<49} w_k * u[5s + c + k], in f32, then
    rounded to ``cfg.decim_dtype``; w_k = bf16(2.2 * taps[k]) is the
    band of ``_decim_tap_matrix_aligned``.

``frontend_decim`` launches the CUDA kernel (``csrc/frontend.cu``) for
tensors on the card; ``frontend_decim_ref`` is the plain version, used
for CPU tensors and as the kernel's reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig
from ..constants import rrc_taps
from ..dsp.mixer import mixer_table
from . import _build

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@functools.lru_cache(maxsize=8)
def _decim_tap_matrix_aligned(alpha: float, ntaps: int, gain: float,
                              cyc: int, chunk: int, zpad: int,
                              klen_pad: int):
    """T[(zpad - ntaps + 1) + j*cyc + c + k, c*chunk + j] = gain*taps[k]."""
    taps = rrc_taps(alpha, ntaps) * gain
    lead = zpad - (ntaps - 1)
    t = np.zeros((klen_pad, cyc * chunk), np.float32)
    for c in range(cyc):
        for j in range(chunk):
            r0 = lead + j * cyc + c
            t[r0:r0 + ntaps, c * chunk + j] = taps
    return t


def decim_taps(cfg: ModemConfig) -> torch.Tensor:
    """[ntaps] f32 tap values of the decimating matmul: column 0 of
    ``_decim_tap_matrix_aligned`` rounded to the front-end dtype, as
    the JAX kernel consumes it."""
    halo = cfg.ntaps - 1
    chunk = 128
    zpad = -(-halo // 128) * 128
    t = _decim_tap_matrix_aligned(cfg.alpha, cfg.ntaps, cfg.fir_gain,
                                  cfg.cycles, chunk, zpad,
                                  zpad + cfg.cycles * chunk)
    lead = zpad - halo
    col = torch.from_numpy(t[lead:lead + cfg.ntaps, 0].copy())
    return col.to(_DTYPES[cfg.frontend_dtype]).float()


def _mixer_planes(cfg: ModemConfig, device) -> torch.Tensor:
    """[2, n] f32 (real, imag) planes of the RX mixer table."""
    table = mixer_table(-cfg.center, cfg.fs, cfg.frame_size)
    return torch.from_numpy(np.stack([table.real, table.imag])).to(device)


def frontend_decim_ref(cfg: ModemConfig, pcm, p0r, p0i, tail0_r, tail0_i,
                       adv):
    """Plain PyTorch version of :func:`frontend_decim`."""
    B, C, n = pcm.shape
    halo = cfg.ntaps - 1
    cyc = cfg.cycles
    n_sym = cfg.symbols_per_block
    zdt = _DTYPES[cfg.frontend_dtype]
    x = pcm.float() * (1.0 / cfg.tx_amplitude)              # [B, C, n]
    ar, ai = adv[0][:, None], adv[1][:, None]               # [B, 1]
    pr = (p0r[None] * ar - p0i[None] * ai)[..., None]       # [B, C, 1]
    pi = (p0r[None] * ai + p0i[None] * ar)[..., None]
    tr, ti = _mixer_planes(cfg, pcm.device)
    zr = (x * (pr * tr - pi * ti)).to(zdt)
    zi = (x * (pr * ti + pi * tr)).to(zdt)
    u = []
    for z, tail0 in ((zr, tail0_r), (zi, tail0_i)):
        h = torch.cat([tail0.to(zdt)[None], z[:-1, :, n - halo:]], 0)
        u.append(torch.cat([h, z], -1).float())             # [B, C, halo+n]
    u = torch.stack(u)                                      # [2, B, C, .]
    w = decim_taps(cfg).to(pcm.device)
    acc = torch.zeros((2, B, C, n), dtype=torch.float32, device=pcm.device)
    for k in range(cfg.ntaps):
        acc = acc + w[k] * u[..., k:k + n]
    # acc[..., t] is the full-rate filter output; phase c keeps t = 5s + c
    dec = acc.reshape(2, B * C, n_sym, cyc).permute(3, 0, 1, 2)
    return dec.to(_DTYPES[cfg.decim_dtype]).contiguous()


def frontend_decim(cfg: ModemConfig, pcm, p0r, p0i, tail0_r, tail0_i,
                   adv):
    """Downmix + RRC matched filter + x5 decimation of every row.

    Args:
      pcm:      [B, C, frame_size] int16.
      p0r/p0i:  [C] f32 mixer phasor entering block 0.
      tail0_r/tail0_i: [C, ntaps-1] f32 downmixed FIR halo entering
                block 0.
      adv:      [2, B] f32 real/imag of adv^b (the per-block advance).

    Returns the decim planes [cycles, 2, B*C, n_sym] in
    ``cfg.decim_dtype``; row n = b*C + ch.
    """
    if pcm.device.type == "cpu":
        return frontend_decim_ref(cfg, pcm, p0r, p0i, tail0_r, tail0_i, adv)
    _build.require_kernel_geometry(cfg)
    B, C, _ = pcm.shape
    if pcm.dtype != torch.int16:
        raise TypeError(f"pcm must be int16, got {pcm.dtype}")
    halo = cfg.ntaps - 1
    for t, shape in ((p0r, (C,)), (p0i, (C,)), (tail0_r, (C, halo)),
                     (tail0_i, (C, halo)), (adv, (2, B))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"expected f32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    ddt = _DTYPES[cfg.decim_dtype]
    out = torch.empty((cfg.cycles, 2, B * C, cfg.symbols_per_block),
                      dtype=ddt, device=pcm.device)
    tab = _mixer_planes(cfg, pcm.device)
    taps = decim_taps(cfg).to(pcm.device)
    ptrs = _build.cuda_args(pcm, p0r, p0i, tail0_r, tail0_i, adv, tab,
                            taps, out, device=pcm.device)
    lib = _build.load()
    err = lib.sc_frontend_decim(
        *ptrs, B, C, int(ddt == torch.bfloat16), 1.0 / cfg.tx_amplitude,
        torch.cuda.current_stream(pcm.device).cuda_stream)
    _build.check(err, "frontend_decim")
    _build.LAUNCHES["frontend_decim"] += 1
    return out
