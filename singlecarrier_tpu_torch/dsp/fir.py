"""Batched streaming complex FIR (RRC pulse shaping / matched filter).

Counterpart of ``singlecarrier_tpu/dsp/fir.py``.  The reference's
one-sample-at-a-time delay line (src/fir.c:22-43) is a cross-correlation
of the taps with the trailing window, so a block filters at once with an
``ntaps-1``-sample carried halo (overlap-save).  Two paths, as in the
JAX package:

* ``direct``: the taps' shifted products summed in ascending tap order;
* ``banded``: tiles of 128 outputs as one dense product against a banded
  [win, 128] matrix, in true f32 (the JAX package runs it at
  ``Precision.HIGHEST``), complex x real as two real products on the
  I/Q planes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import on_device, require_true_f32, resolve_device

_LANE = 128     # banded tiles are one TPU lane wide, as in the JAX package


def fir_init_state(ntaps: int, batch_shape=(), dtype=torch.complex64,
                   device=None) -> torch.Tensor:
    """Zero delay-line halo: the last ``ntaps-1`` inputs (fir.c:30-34),
    on the card unless ``device`` says otherwise."""
    return torch.zeros((*batch_shape, ntaps - 1), dtype=dtype,
                       device=resolve_device(device))


@functools.lru_cache(maxsize=16)
def banded_fir_matrix(taps_key, ntaps: int, tile: int = _LANE) -> np.ndarray:
    """Banded matrix W[win, tile] with W[t+k, t] = taps[k], so
    ``x_window @ W`` is ``y[t] = sum_k x[t+k] taps[k]`` for ``tile``
    consecutive outputs (``win = tile + ntaps - 1``)."""
    taps = np.asarray(taps_key, dtype=np.float32)
    win = tile + ntaps - 1
    w = np.zeros((win, tile), dtype=np.float32)
    for t in range(tile):
        w[t:t + ntaps, t] = taps
    return w


def _extend(state: torch.Tensor, x: torch.Tensor):
    """Prepend the carried halo; split the new halo off the tail."""
    x_ext = torch.cat([state, x], dim=-1)
    return x_ext, x_ext[..., x.shape[-1]:]


def _fir_direct(taps, x_ext: torch.Tensor, n_out: int) -> torch.Tensor:
    """Cross-correlation as the taps' shifted products, ascending k."""
    y = torch.zeros_like(x_ext[..., :n_out])
    for k, t in enumerate(np.asarray(taps, np.float32)):
        y = y + x_ext[..., k:k + n_out] * float(t)
    return y


def _fir_banded(taps, x_ext: torch.Tensor, n_out: int,
                tile: int = _LANE) -> torch.Tensor:
    """Overlap-save banded product: tiles of ``tile`` outputs."""
    ntaps = len(taps)
    win = tile + ntaps - 1
    ntiles = -(-n_out // tile)
    pad = ntiles * tile + ntaps - 1 - x_ext.shape[-1]
    if pad > 0:
        x_ext = torch.cat([x_ext, x_ext.new_zeros((*x_ext.shape[:-1], pad))],
                          dim=-1)
    # window j covers x_ext[j*tile : j*tile + win]
    windows = x_ext.unfold(-1, win, tile)[..., :ntiles, :]
    w = on_device(banded_fir_matrix, (
        tuple(np.asarray(taps, np.float32).tolist()), ntaps, tile),
        x_ext.device)
    require_true_f32(windows.real)
    y = torch.complex(torch.matmul(windows.real, w),
                      torch.matmul(windows.imag, w))
    return y.reshape(*y.shape[:-2], ntiles * tile)[..., :n_out]


def fir_block(taps, gain: float, state: torch.Tensor, x: torch.Tensor, *,
              method: str = "banded"):
    """Filter one block; returns ``(y, new_state)``.

    ``y[t] = gain * sum_k taps[k] * x_cont[t - (ntaps-1) + k]`` over the
    continuous stream ``x_cont`` (halo carried in ``state``), as
    ``fir(memory, choice, sample, length)`` (src/fir.c:22-43).
    ``taps``: [ntaps] real (numpy); ``state``: [..., ntaps-1]; ``x``:
    [..., n] complex.
    """
    n_out = x.shape[-1]
    x_ext, new_state = _extend(state, x)
    if method == "direct":
        y = _fir_direct(taps, x_ext, n_out)
    elif method == "banded":
        y = _fir_banded(taps, x_ext, n_out)
    else:
        raise ValueError(f"unknown FIR method: {method}")
    return y * gain, new_state
