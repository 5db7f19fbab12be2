"""Closed-form least-squares equalizer of the XLA production path.

Counterpart of ``singlecarrier_tpu/adaptive/ls_equalizer.py``: the
reference's 128 sequential square-root-Kalman updates
(src/equalizer.c:45-58) are replaced by the batch solution of the same
least-squares problem, ``coeff = argmin ||C coeff - p||^2 + ridge``, with
C[t, i] = sym[lag + t + i - L//2]: two small products and one 5x5 solve.
Decoding applies the frozen filter to every data window, then a
decision-directed phase/frequency refinement.

Every function runs over leading batch dims (the JAX package ``vmap``s
them).  All products are complex f32 in true f32 (``Precision.HIGHEST``
there); the refinement keeps ``atan2`` (``torch.angle``), where the
decode kernels use their own small-angle forms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import require_true_f32
from ..utils.linalg import chol_solve_hermitian

_C64 = torch.complex64


def window_matrix(symbols: torch.Tensor, start: int, count: int, L: int, *,
                  center: bool = True) -> torch.Tensor:
    """C[..., t, i] = symbols[..., start + t + i - off] for t < count,
    i < L (off = L//2 with ``center``, else 0: the reference's
    alignment, equalizer.c:48).  The slice start is taken as
    ``lax.dynamic_slice`` takes it: a negative one counts from the end,
    then it is clamped into the array (callers keep start >= off)."""
    off = L // 2 if center else 0
    span, n = count + L - 1, symbols.shape[-1]
    s0 = start - off + (n if start < off else 0)
    s0 = min(max(s0, 0), n - span)
    s = symbols[..., s0:s0 + span]
    return torch.stack([s[..., i:i + count] for i in range(L)], dim=-1)


def _ridge_diag(L: int, reg: float, offtap_reg) -> np.ndarray:
    """Scale-relative ridge diagonal: ``reg`` on the center tap,
    ``offtap_reg`` on the others (``None``: the uniform ridge)."""
    d = np.full(L, reg if offtap_reg is None else offtap_reg, np.float32)
    d[L // 2] = reg
    return np.diag(d)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    require_true_f32(a)
    return torch.matmul(a, b)


def _regularized_gram(C: torch.Tensor, L: int, reg: float, offtap_reg):
    """C^H C plus the trace-relative ridge and 1e-12 I."""
    A = _matmul(C.conj().mT, C)
    scale = (torch.diagonal(A, dim1=-2, dim2=-1).real.sum(-1) / L)[
        ..., None, None]
    ridge = torch.from_numpy(_ridge_diag(L, reg, offtap_reg)).to(A.device)
    eye = torch.eye(L, dtype=_C64, device=A.device)
    return A + scale * ridge.to(_C64) + 1e-12 * eye


def ls_train(symbols: torch.Tensor, lag: int, pn: torch.Tensor, L: int,
             reg: float = 1e-4, offtap_reg=None):
    """Fit the equalizer on the preamble; returns ``(coeff, matches)``.

    ``symbols``: [..., n] complex window; ``pn``: [P] f32 +/-1 chips;
    ``reg`` / ``offtap_reg``: center and off-center ridge.  ``coeff``
    [..., L] complex; ``matches`` [...] i32: sign agreements of the
    fitted output with the chips (the detection statistic,
    qpsk.c:111-123).
    """
    C = window_matrix(symbols, lag, pn.shape[-1], L)          # [..., P, L]
    A = _regularized_gram(C, L, reg, offtap_reg)
    b = _matmul(C.conj().mT, pn.to(_C64)[:, None])[..., 0]
    coeff = chol_solve_hermitian(A, b)
    val = _matmul(C, coeff[..., None])[..., 0]
    matches = ((val.real * pn) > 0.0).sum(-1).to(torch.int32)
    return coeff, matches


def ls_decode(symbols: torch.Tensor, start: int, coeff: torch.Tensor,
              n_data: int) -> torch.Tensor:
    """The frozen filter on all ``n_data`` windows: [..., n_data] raw
    outputs in the training domain (raw = s (1-j)/2)."""
    C = window_matrix(symbols, start, n_data, coeff.shape[-1])
    return _matmul(C, coeff[..., None])[..., 0]


def slice_qpsk(raw: torch.Tensor):
    """Hard decisions from raw training-domain outputs: ``(dibits u8,
    hard_raw)``, ``hard_raw`` the ideal raw-domain point."""
    sym = raw * complex(1.0, 1.0)
    i_bit = sym.real < 0.0
    q_bit = sym.imag < 0.0
    hard = torch.complex(torch.where(i_bit, -1.0, 1.0),
                         torch.where(q_bit, -1.0, 1.0))
    hard_raw = hard * complex(0.5, -0.5)
    dibit = (i_bit.to(torch.uint8) << 1) | q_bit.to(torch.uint8)
    return dibit, hard_raw


def ls_refit(symbols: torch.Tensor, start: int, coeff: torch.Tensor,
             n_data: int, reg: float = 1e-3, offtap_reg=None,
             n_fit: int = 0) -> torch.Tensor:
    """Decision-directed LS refit on the first ``n_fit`` data windows (0:
    all ``n_data``), targets rescaled to the data amplitude (the
    preamble trains at half of it, qpsk.c:313-319).  Returns the
    refitted coeff."""
    L = coeff.shape[-1]
    C = window_matrix(symbols, start, n_fit or n_data, L)
    raw = _matmul(C, coeff[..., None])[..., 0]
    _, hard_raw = slice_qpsk(raw)
    scale = raw.abs().mean(-1, keepdim=True) / (
        hard_raw.abs().mean(-1, keepdim=True) + 1e-12)
    target = hard_raw * scale
    A = _regularized_gram(C, L, reg, offtap_reg)
    b = _matmul(C.conj().mT, target[..., None])[..., 0]
    return chol_solve_hermitian(A, b)


def _refine_err(x: torch.Tensor) -> torch.Tensor:
    """Amplitude-normalized mean decision distance (the refine guard's
    metric; also the reported eq_error)."""
    _, hard = slice_qpsk(x)
    s = x.abs().mean(-1, keepdim=True) + 1e-9
    return (x / s - hard / hard.abs()).abs().mean(-1)


def _expj(ang: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(ang), torch.sin(ang))


def phase_refine(raw: torch.Tensor, iterations: int = 3):
    """Decision-directed phase/frequency refinement, vectorized.

    The residual is modelled as raw_k exp(j(a + b k)); from the decision
    rotors z_k = raw_k conj(hard_k): b = angle(sum z_{k+1} conj(z_k)),
    a = angle(sum z_k e^{-jbk}), each clamped to pi/8 (per packet /
    per symbol).  A pass is kept only where it does not increase the
    mean decision distance.  Returns ``(corrected, dibits, err)``.
    """
    n = raw.shape[-1]
    k = torch.arange(n, dtype=torch.float32, device=raw.device)
    a_max = float(np.float32(np.pi / 8.0))
    b_max = float(np.float32(np.pi / 8.0 / max(n, 1)))
    cur = raw
    for _ in range(iterations):
        _, hard_raw = slice_qpsk(cur)
        z = cur * hard_raw.conj()
        inc = (z[..., 1:] * z[..., :-1].conj()).sum(-1)
        b = torch.angle(inc).clamp(-b_max, b_max)
        derot = _expj(-b[..., None] * k)
        a = torch.angle((z * derot).sum(-1)).clamp(-a_max, a_max)
        cand = cur * (_expj(-a)[..., None] * derot)
        keep = (_refine_err(cand) <= _refine_err(cur))[..., None]
        cur = torch.where(keep, cand, cur)
    dibits, hard_raw = slice_qpsk(cur)
    scale = cur.abs().mean(-1, keepdim=True) + 1e-9
    err = (cur / scale - hard_raw / hard_raw.abs()).abs().mean(-1)
    return cur, dibits, err
