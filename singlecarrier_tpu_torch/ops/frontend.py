"""The front-ends: int16 PCM -> decimated symbol planes.

:func:`frontend_decim` is the counterpart of the front-end stage of
``singlecarrier_tpu/ops/fused_rx.py::_fused_rx_kernel_premix``
(``fused_rx.py:166-209``), which does the math of
``ops/frontend_pallas.py::_kernel_decim_aligned``: per (block b,
channel ch) row

  * mixer phase p_b = p0 * adv^b (``adv`` tabulated in float64);
  * z = bf16(x * (pr*tr - pi*ti)), bf16(x * (pr*ti + pi*tr)) with
    x = pcm * 2^-14 and (tr, ti) the float64 mixer table (rounded to
    ``cfg.frontend_dtype``: bf16 as here, or left in f32);
  * u = [halo(48) | z(1880)], the halo being the carried tail for
    b = 0 and the last 48 z values of block b-1 otherwise;
  * decim[c, p, n, s] = sum_{k<49} w_k * u[5s + c + k], in f32, then
    rounded to ``cfg.decim_dtype``; w_k = bf16(2.2 * taps[k]) (f32 under
    ``cfg.frontend_dtype="f32"``) is the band of
    ``_decim_tap_matrix_aligned``.

:func:`fused_frontend_decim` is the counterpart of the stand-alone
front-end ``ops/frontend_pallas.py::fused_frontend_decim`` (:438):
the same sums, but every row is given its own mixer phase and its
already-downmixed f32 halo, and the planes come out transposed
([cyc, 2, N, n_sym] in ``cfg.decim_dtype``) or row-major
([N, cyc, 2, n_sym], always f32).

Its kernel wrapper is :func:`frontend_rows`; the new tail and phase
are O(N) tensor glue around it.

With ``mixer_fold`` (argument, or ``cfg.mixer_fold``) both run the
mixer-folded math of ``fused_rx.py::_fused_rx_kernel_folded`` (:217) and
``frontend_pallas.py::_kernel_decim_folded`` (:286): one raw plane
u = [halo | bf16(x)], two 49-term sums against the real and imaginary
parts of the complex taps c_k = bf16(2.2 * taps[k] * e^{jw(k-48)}), and
the mixer as a rotation of the decimated sums by phase * table[5s + c].
The per-row form un-rotates each row's downmixed halo back to raw
samples; the batch form takes the halo of a block b > 0 from the
previous block's raw PCM and un-rotates only the carried seed.

:func:`fused_frontend` is the counterpart of
``ops/frontend_pallas.py::fused_frontend`` (:73): downmix and the
full-rate 49-tap filter in f32 with no bf16 rounding, [C, frame_size]
real and imaginary outputs; its kernel wrapper is :func:`frontend_full`.

Each wrapper launches its CUDA kernel (``csrc/frontend.cu``, built for
the config's geometry) for tensors on the card and refuses, on either
device, a config outside ``_build.kernel_limits``;
``frontend_decim_ref``, ``frontend_rows_ref``,
``frontend_decim_folded_ref``, ``frontend_rows_folded_ref`` and
``frontend_full_ref`` (``fused_frontend_decim_ref`` and
``fused_frontend_ref`` with the state out) are the plain versions, used
for CPU tensors and as the kernels' references.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig
from ..constants import rrc_taps
from ..dsp.mixer import mixer_table, tail_table
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


@functools.lru_cache(maxsize=8)
def _kernel_tables(cfg: ModemConfig, dev):
    """(mixer planes, taps) operands of the kernels, uploaded once per
    (config, device): a per-block streaming loop must not wait on host
    copies."""
    return _mixer_planes(cfg, dev), decim_taps(cfg).to(dev)


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


@functools.lru_cache(maxsize=8)
def _fold_tables(cfg: ModemConfig, dev):
    """(ctaps [2, ntaps], unrot [2, halo]) f32 on ``dev``: real/imag of
    the folded taps c_k = gain * taps[k] * e^{jw(k-halo)} (float64, cast
    to f32, rounded to the front-end dtype as the JAX kernel consumes
    ``_decim_tap_matrix_folded``) and cos/sin of w(m-halo+1), the halo
    un-rotation of ``frontend_pallas._fold_tables``."""
    halo = cfg.ntaps - 1
    w = -2.0 * np.pi * cfg.center / cfg.fs
    taps = rrc_taps(cfg.alpha, cfg.ntaps) * cfg.fir_gain
    ck = taps * np.exp(1j * w * (np.arange(cfg.ntaps) - halo))
    eu = np.exp(1j * w * (np.arange(halo) - halo + 1))
    ctaps = torch.from_numpy(np.stack([ck.real, ck.imag]).astype(np.float32))
    unrot = torch.from_numpy(np.stack([eu.real, eu.imag]).astype(np.float32))
    return (ctaps.to(_DTYPES[cfg.frontend_dtype]).float().to(dev),
            unrot.to(dev))


@functools.lru_cache(maxsize=8)
def _full_taps(cfg: ModemConfig, dev) -> torch.Tensor:
    """[ntaps] unrounded f32 RRC taps (the full-rate kernel multiplies
    them by the gain itself), uploaded once per (config, device)."""
    return torch.from_numpy(rrc_taps(cfg.alpha, cfg.ntaps)).to(dev)


@functools.lru_cache(maxsize=8)
def _mixer_planes(cfg: ModemConfig, device) -> torch.Tensor:
    """[2, n] f32 (real, imag) planes of the RX mixer table, uploaded
    once per (config, device)."""
    table = mixer_table(-cfg.center, cfg.fs, cfg.frame_size)
    return torch.from_numpy(np.stack([table.real, table.imag])).to(device)


def _tap_sums(cfg: ModemConfig, u):
    """acc[..., t] = sum_k w_k u[..., t + k] in ascending k, f32: the
    full-rate matched-filter output of ``u`` = [halo | z]."""
    n = cfg.frame_size
    w = decim_taps(cfg).to(u.device)
    acc = torch.zeros((*u.shape[:-1], n), dtype=torch.float32,
                      device=u.device)
    for k in range(cfg.ntaps):
        acc = acc + w[k] * u[..., k:k + n]
    return acc


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
    acc = _tap_sums(cfg, torch.stack(u))                    # [2, B, C, n]
    # acc[..., t] is the full-rate filter output; phase c keeps t = 5s + c
    dec = acc.reshape(2, B * C, n_sym, cyc).permute(3, 0, 1, 2)
    return dec.to(_DTYPES[cfg.decim_dtype]).contiguous()


def _unrotate(cfg: ModemConfig, tail_r, tail_i, pr, pi):
    """Raw halo samples (front-end dtype) of downmixed tail planes
    [..., halo] carried with phase (pr, pi) [..., 1]:
    Re[tail * conj(phase) * e^{-jw(m-halo+1)}]."""
    eur, eui = _fold_tables(cfg, tail_r.device)[1]
    a = tail_r * pr + tail_i * pi
    b = tail_i * pr - tail_r * pi
    return (a * eur + b * eui).to(_DTYPES[cfg.frontend_dtype])


def _folded_sums(cfg: ModemConfig, u, pr, pi):
    """Full-rate folded filter output [2, R, n] f32 of the raw plane
    ``u`` [R, halo + n]: A + jB = sum_k c_k u[t + k] in ascending k,
    rotated by (pr + j pi) [R, 1] times the mixer table at t."""
    n = cfg.frame_size
    cre, cim = _fold_tables(cfg, u.device)[0]
    A = torch.zeros((u.shape[0], n), dtype=torch.float32, device=u.device)
    B = torch.zeros_like(A)
    for k in range(cfg.ntaps):
        A = A + cre[k] * u[:, k:k + n]
        B = B + cim[k] * u[:, k:k + n]
    ta, tb = _mixer_planes(cfg, u.device)
    mr = pr * ta - pi * tb
    mi = pr * tb + pi * ta
    return torch.stack([mr * A - mi * B, mr * B + mi * A])


def frontend_decim_folded_ref(cfg: ModemConfig, pcm, p0r, p0i, tail0_r,
                              tail0_i, adv):
    """Plain PyTorch version of :func:`frontend_decim` with the mixer
    folded."""
    B, C, n = pcm.shape
    halo = cfg.ntaps - 1
    zdt = _DTYPES[cfg.frontend_dtype]
    z = (pcm.float() * (1.0 / cfg.tx_amplitude)).to(zdt)    # [B, C, n]
    ar, ai = adv[0][:, None], adv[1][:, None]               # [B, 1]
    pr = (p0r[None] * ar - p0i[None] * ai)[..., None]       # [B, C, 1]
    pi = (p0r[None] * ai + p0i[None] * ar)[..., None]
    h0 = _unrotate(cfg, tail0_r, tail0_i, pr[0], pi[0])
    h = torch.cat([h0[None], z[:-1, :, n - halo:]], 0)
    u = torch.cat([h, z], -1).float().reshape(B * C, halo + n)
    acc = _folded_sums(cfg, u, pr.reshape(-1, 1), pi.reshape(-1, 1))
    dec = acc.reshape(2, B * C, cfg.symbols_per_block,
                      cfg.cycles).permute(3, 0, 1, 2)
    return dec.to(_DTYPES[cfg.decim_dtype]).contiguous()


def frontend_decim(cfg: ModemConfig, pcm, p0r, p0i, tail0_r, tail0_i,
                   adv, *, mixer_fold: bool | None = None):
    """Downmix + RRC matched filter + x5 decimation of every row.

    Args:
      pcm:      [B, C, frame_size] int16.
      p0r/p0i:  [C] f32 mixer phasor entering block 0.
      tail0_r/tail0_i: [C, ntaps-1] f32 downmixed FIR halo entering
                block 0.
      adv:      [2, B] f32 real/imag of adv^b (the per-block advance).

    Returns the decim planes [cycles, 2, B*C, n_sym] in
    ``cfg.decim_dtype``; row n = b*C + ch.  ``mixer_fold`` (default
    ``cfg.mixer_fold``) runs the mixer-folded kernel; its halo of block 0
    is ``tail0`` un-rotated, and a carried tail whose un-rotated samples
    fall below 2^-80 without being 0 is outside the kernel's contract
    (see :func:`frontend_rows`).

    A config outside ``_build.kernel_limits`` raises here for tensors on
    either device.
    """
    fold = cfg.mixer_fold if mixer_fold is None else mixer_fold
    _build.kernel_limits(cfg)
    if pcm.device.type == "cpu":
        ref = frontend_decim_folded_ref if fold else frontend_decim_ref
        return ref(cfg, pcm, p0r, p0i, tail0_r, tail0_i, adv)
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
    name, tables = _kernel_operands(cfg, "frontend_decim", fold, pcm.device)
    ptrs = _build.cuda_args(pcm, p0r, p0i, tail0_r, tail0_i, adv, *tables,
                            out, device=pcm.device)
    err = getattr(_build.load(cfg), "sc_" + name)(
        *ptrs, B, C, int(ddt == torch.bfloat16), 1.0 / cfg.tx_amplitude,
        int(cfg.frontend_dtype == "f32"),
        torch.cuda.current_stream(pcm.device).cuda_stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def _kernel_operands(cfg: ModemConfig, name: str, fold: bool, dev):
    """(kernel name, constant-table operands) of a decimating front-end:
    (mixer planes, taps), or folded (mixer planes, complex taps, halo
    un-rotation)."""
    if fold:
        return name + "_folded", (_mixer_planes(cfg, dev),
                                  *_fold_tables(cfg, dev))
    return name, _kernel_tables(cfg, dev)


# ------------------------------------------- per-row phases and halos

def _check_rows_config(cfg: ModemConfig, debug_mode: str = "none"):
    """Refuse the TPU kernel's cost probes (``debug_mode``), which have
    no counterpart; every config the decimating kernels take runs."""
    if debug_mode != "none":
        raise NotImplementedError(
            f"debug_mode={debug_mode!r} is a cost probe of the TPU kernel "
            "and has no counterpart; ROADMAP: not to port (stage probes)")


def _frontend_state_out(cfg: ModemConfig, decim, pcm, phase_r, phase_i):
    """New FIR tail + phase advance of every row
    (``frontend_pallas._frontend_state_out``; it divides by
    ``tx_amplitude`` where the batch path multiplies by the inverse,
    each kept as written)."""
    n, halo = cfg.frame_size, cfg.ntaps - 1
    table = mixer_table(-cfg.center, cfg.fs, n)
    x_t = pcm[:, n - halo:].float() / cfg.tx_amplitude
    tr_t, ti_t = tail_table(cfg.center, cfg.fs, n, halo, pcm.device)
    ntail_r = x_t * (phase_r[:, None] * tr_t - phase_i[:, None] * ti_t)
    ntail_i = x_t * (phase_r[:, None] * ti_t + phase_i[:, None] * tr_t)
    adv = table[n - 1]
    a_r, a_i = float(adv.real), float(adv.imag)
    npr = phase_r * a_r - phase_i * a_i
    npi = phase_r * a_i + phase_i * a_r
    mag = torch.sqrt(npr * npr + npi * npi)
    return decim, ntail_r, ntail_i, npr / mag, npi / mag


def frontend_rows_ref(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r,
                      tail_i, *, transposed: bool = False):
    """Plain PyTorch version of :func:`frontend_rows`."""
    zdt = _DTYPES[cfg.frontend_dtype]
    x = pcm.float() * (1.0 / cfg.tx_amplitude)              # [N, n]
    pr, pi = phase_r[:, None], phase_i[:, None]
    tr, ti = _mixer_planes(cfg, pcm.device)
    zr = (x * (pr * tr - pi * ti)).to(zdt)
    zi = (x * (pr * ti + pi * tr)).to(zdt)
    u = torch.stack([torch.cat([tail_r.to(zdt), zr], -1),
                     torch.cat([tail_i.to(zdt), zi], -1)]).float()
    return _rows_out(cfg, _tap_sums(cfg, u), transposed)


def _rows_out(cfg: ModemConfig, acc, transposed: bool):
    """Full-rate filter output [2, N, n] -> the decim planes of
    :func:`frontend_rows` in the layout asked for."""
    acc = acc.reshape(2, acc.shape[1], cfg.symbols_per_block, cfg.cycles)
    if transposed:
        return acc.permute(3, 0, 1, 2).to(
            _DTYPES[cfg.decim_dtype]).contiguous()
    return acc.permute(1, 3, 0, 2).contiguous()


def _check_row_operands(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r,
                        tail_i):
    N = pcm.shape[0]
    if pcm.dtype != torch.int16 or tuple(pcm.shape) != (N, cfg.frame_size):
        raise TypeError(f"pcm must be int16 [N, {cfg.frame_size}], got "
                        f"{pcm.dtype} {tuple(pcm.shape)}")
    halo = cfg.ntaps - 1
    for t, shape in ((phase_r, (N,)), (phase_i, (N,)),
                     (tail_r, (N, halo)), (tail_i, (N, halo))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"expected f32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def frontend_rows_folded_ref(cfg: ModemConfig, pcm, phase_r, phase_i,
                             tail_r, tail_i, *, transposed: bool = False):
    """Plain PyTorch version of :func:`frontend_rows` with the mixer
    folded."""
    zdt = _DTYPES[cfg.frontend_dtype]
    pr, pi = phase_r[:, None], phase_i[:, None]
    z = (pcm.float() * (1.0 / cfg.tx_amplitude)).to(zdt)
    u = torch.cat([_unrotate(cfg, tail_r, tail_i, pr, pi), z], -1).float()
    return _rows_out(cfg, _folded_sums(cfg, u, pr, pi), transposed)


def frontend_rows(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r, tail_i,
                  *, transposed: bool = False,
                  mixer_fold: bool | None = None):
    """Downmix + RRC matched filter + x5 decimation of N independent
    rows, each with its own mixer phase and downmixed halo (the kernel of
    :func:`fused_frontend_decim`, whose arguments these are).  Returns
    the decim planes: [N, cycles, 2, n_sym] f32, or with ``transposed``
    [cycles, 2, N, n_sym] in ``cfg.decim_dtype``.  ``mixer_fold``
    (default ``cfg.mixer_fold``) runs the mixer-folded kernel.

    With bf16 operands (``cfg.frontend_dtype``) the kernels fuse their
    tap sums (``csrc/frontend.cu::tap_sums``), which returns the plain
    version's bits while every tap times sample is exact in f32; with f32
    operands they take each product and sum on its own.  For the folded
    kernel's smallest tap exactness needs each un-rotated halo sample to
    be 0 or at least 2^-80 in magnitude:
    a tail carried from int16 PCM (``_frontend_state_out``,
    ``downmix_tail``) and un-rotated with the phase that follows it
    always is; a tail made otherwise that breaks the bound is outside the
    contract, and the planes may then differ from the plain version's.

    A config outside ``_build.kernel_limits`` raises here for tensors on
    either device.
    """
    fold = cfg.mixer_fold if mixer_fold is None else mixer_fold
    _build.kernel_limits(cfg)
    if pcm.device.type == "cpu":
        ref = frontend_rows_folded_ref if fold else frontend_rows_ref
        return ref(cfg, pcm, phase_r, phase_i, tail_r, tail_i,
                   transposed=transposed)
    _check_row_operands(cfg, pcm, phase_r, phase_i, tail_r, tail_i)
    N = pcm.shape[0]
    dev = pcm.device
    n_sym = cfg.symbols_per_block
    if transposed:
        ddt = _DTYPES[cfg.decim_dtype]
        layout = int(ddt == torch.bfloat16)
        out = torch.empty((cfg.cycles, 2, N, n_sym), dtype=ddt, device=dev)
    else:
        layout = 2
        out = torch.empty((N, cfg.cycles, 2, n_sym), dtype=torch.float32,
                          device=dev)
    name, tables = _kernel_operands(cfg, "frontend_rows", fold, dev)
    ptrs = _build.cuda_args(pcm, phase_r, phase_i, tail_r, tail_i, *tables,
                            out, device=dev)
    err = getattr(_build.load(cfg), "sc_" + name)(
        *ptrs, N, layout, 1.0 / cfg.tx_amplitude,
        int(cfg.frontend_dtype == "f32"),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def fused_frontend_decim_ref(cfg: ModemConfig, pcm, phase_r, phase_i,
                             tail_r, tail_i, *, transposed: bool = False,
                             mixer_fold: bool | None = None):
    """Plain PyTorch version of :func:`fused_frontend_decim`."""
    fold = cfg.mixer_fold if mixer_fold is None else mixer_fold
    ref = frontend_rows_folded_ref if fold else frontend_rows_ref
    decim = ref(cfg, pcm, phase_r, phase_i, tail_r, tail_i,
                transposed=transposed)
    return _frontend_state_out(cfg, decim, pcm, phase_r, phase_i)


def fused_frontend_decim(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r,
                         tail_i, *, block_channels: int = 256,
                         chunk: int = 128, transposed: bool = False,
                         aligned: bool = True, debug_mode: str = "none",
                         mixer_fold: bool | None = None,
                         interpret: bool = False):
    """Front-end of N independent rows, each with its own phase and halo.

    Args:
      pcm:             [N, frame_size] int16.
      phase_r/phase_i: [N] f32 mixer phasor entering each row's block.
      tail_r/tail_i:   [N, ntaps-1] f32 downmixed FIR halo of each row.

    Returns ``(decim, new_tail_r, new_tail_i, new_phase_r,
    new_phase_i)``: ``decim`` from :func:`frontend_rows`, the state out
    as O(N) tensor glue.

    ``mixer_fold`` (default ``cfg.mixer_fold``) runs the mixer-folded
    kernel.  ``block_channels``, ``chunk``, ``aligned`` and ``interpret``
    only size or route the TPU kernel; they are accepted and ignored so
    that a call written for the JAX package runs unchanged (the JAX
    launcher drops the fold when ``aligned`` is false; the port has one
    kernel and folds whenever asked).
    """
    _check_rows_config(cfg, debug_mode)
    decim = frontend_rows(cfg, pcm, phase_r, phase_i, tail_r, tail_i,
                          transposed=transposed, mixer_fold=mixer_fold)
    return _frontend_state_out(cfg, decim, pcm, phase_r, phase_i)


# ------------------------------------------- the full-rate front-end

def frontend_full_ref(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r,
                      tail_i):
    """Plain PyTorch version of :func:`frontend_full`."""
    n = cfg.frame_size
    x = pcm.float() * (1.0 / cfg.tx_amplitude)              # [C, n]
    pr, pi = phase_r[:, None], phase_i[:, None]
    tr, ti = _mixer_planes(cfg, pcm.device)
    u = torch.stack([torch.cat([tail_r, x * (pr * tr - pi * ti)], -1),
                     torch.cat([tail_i, x * (pr * ti + pi * tr)], -1)], 1)
    w = _full_taps(cfg, pcm.device) * torch.tensor(cfg.fir_gain,
                                                   dtype=torch.float32)
    acc = torch.zeros((pcm.shape[0], 2, n), dtype=torch.float32,
                      device=pcm.device)
    for k in range(cfg.ntaps):
        acc = acc + w[k] * u[..., k:k + n]
    return acc


def frontend_full(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r, tail_i):
    """Downmix + full-rate RRC matched filter of C rows, all in f32:
    y[p][t] = sum_k (taps[k] * gain) * u[p][t + k] in ascending k over
    u = [tail | downmixed block].  Returns [C, 2, frame_size] f32 (the
    kernel of :func:`fused_frontend`, whose arguments these are).  A
    config outside ``_build.kernel_limits`` raises on either device."""
    _build.kernel_limits(cfg)
    if pcm.device.type == "cpu":
        return frontend_full_ref(cfg, pcm, phase_r, phase_i, tail_r, tail_i)
    _check_row_operands(cfg, pcm, phase_r, phase_i, tail_r, tail_i)
    C, dev = pcm.shape[0], pcm.device
    out = torch.empty((C, 2, cfg.frame_size), dtype=torch.float32,
                      device=dev)
    ptrs = _build.cuda_args(pcm, phase_r, phase_i, tail_r, tail_i,
                            _mixer_planes(cfg, dev), _full_taps(cfg, dev),
                            out, device=dev)
    err = _build.load(cfg).sc_frontend_full(
        *ptrs, C, 1.0 / cfg.tx_amplitude, float(cfg.fir_gain),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "frontend_full")
    _build.LAUNCHES["frontend_full"] += 1
    return out


def _fused_frontend_out(cfg: ModemConfig, filt, pcm, phase_r, phase_i):
    _, ntr, nti, npr, npi = _frontend_state_out(cfg, None, pcm, phase_r,
                                                phase_i)
    return filt[:, 0], filt[:, 1], ntr, nti, npr, npi


def fused_frontend_ref(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r,
                       tail_i):
    """Plain PyTorch version of :func:`fused_frontend`."""
    filt = frontend_full_ref(cfg, pcm, phase_r, phase_i, tail_r, tail_i)
    return _fused_frontend_out(cfg, filt, pcm, phase_r, phase_i)


def fused_frontend(cfg: ModemConfig, pcm, phase_r, phase_i, tail_r, tail_i,
                   *, block_channels: int = 256, interpret: bool = False):
    """Full-rate front-end of C rows.

    Args as :func:`fused_frontend_decim`.  Returns ``(filt_r, filt_i,
    new_tail_r, new_tail_i, new_phase_r, new_phase_i)``; ``filt_*`` are
    the [C, frame_size] f32 matched-filter outputs (views of one
    [C, 2, frame_size] tensor).  ``cfg.frontend_dtype`` and
    ``cfg.decim_dtype`` play no part: nothing is rounded to bf16.
    ``block_channels`` and ``interpret`` only size the TPU kernel;
    accepted and ignored.
    """
    filt = frontend_full(cfg, pcm, phase_r, phase_i, tail_r, tail_i)
    return _fused_frontend_out(cfg, filt, pcm, phase_r, phase_i)
