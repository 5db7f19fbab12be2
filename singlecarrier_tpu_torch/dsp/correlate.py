"""Preamble correlation (sync hunt), ``singlecarrier_tpu/dsp/correlate.py``.

The reference's 128-lag sliding-window loop (src/qpsk.c:176-183 calling
correlate(), qpsk.c:88-96) as one product against a banded matrix
``W[i+k, i] = preamble[k]``, batched over channels.  The product is the
reference's NON-conjugated one (qpsk.c:92; every preamble chip shares
the 45-degree phase, qpsk.c:361-365), written as real products on the
I/Q planes in true f32.  ``window_energy`` is magnitude()
(qpsk.c:101-109) for every lag at once by a cumulative sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import on_device, require_true_f32


@functools.lru_cache(maxsize=8)
def preamble_corr_matrix(pre_key, n_lags: int) -> np.ndarray:
    """W[n_lags + P - 1, n_lags] complex with W[i+k, i] = pre[k]."""
    pre = np.asarray(pre_key, dtype=np.complex64)
    p = len(pre)
    w = np.zeros((n_lags + p - 1, n_lags), dtype=np.complex64)
    for i in range(n_lags):
        w[i:i + p, i] = pre
    return w


@functools.lru_cache(maxsize=8)
def _corr_planes(pre_key, n_lags: int) -> np.ndarray:
    """[2, n_lags + P - 1, n_lags] f32: W's real and imaginary planes."""
    w = preamble_corr_matrix(pre_key, n_lags)
    return np.stack([w.real, w.imag]).astype(np.float32)


def preamble_correlate(symbols: torch.Tensor, preamble: np.ndarray,
                       n_lags: int) -> torch.Tensor:
    """|sum_k pre[k] * sym[lag+k]|^2 for lag in [0, n_lags).

    ``symbols``: [..., >= n_lags + P - 1] complex; ``preamble``: [P]
    complex (numpy).  Returns [..., n_lags] f32 powers, as
    fabsf(cnormf(out)) (qpsk.c:95).
    """
    p = len(preamble)
    key = tuple(complex(c) for c in np.asarray(preamble, np.complex64))
    wr, wi = on_device(_corr_planes, (key, n_lags), symbols.device)
    d = symbols[..., :n_lags + p - 1]
    dr, di = d.real, d.imag
    require_true_f32(dr)
    out_r = torch.matmul(dr, wr) - torch.matmul(di, wi)
    out_i = torch.matmul(dr, wi) + torch.matmul(di, wr)
    return (out_r * out_r + out_i * out_i).abs()


def window_energy(symbols: torch.Tensor, p: int,
                  n_lags: int) -> torch.Tensor:
    """sum_{k=lag}^{lag+P-1} |sym[k]|^2 for every lag (qpsk.c:101-109)."""
    e = symbols.real ** 2 + symbols.imag ** 2
    c = torch.cumsum(e[..., :n_lags + p - 1], dim=-1)
    c = torch.cat([c.new_zeros((*c.shape[:-1], 1)), c], dim=-1)
    return c[..., p:p + n_lags] - c[..., :n_lags]
