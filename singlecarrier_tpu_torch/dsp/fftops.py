"""DFT table of the CFO search (``singlecarrier_tpu/dsp/fftops.py``)."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def dft_matrix(p: int, nfft: int) -> np.ndarray:
    """[p, nfft] DFT analysis matrix (host, complex64)."""
    k = np.arange(p)[:, None]
    f = np.arange(nfft)[None, :]
    return np.exp(-2j * np.pi * k * f / nfft).astype(np.complex64)
