"""Blocked-scan square-root-Kalman/RLS equalizer updates
(``singlecarrier_tpu/adaptive/blocked_rls.py``).

The reference chains one Hsu-1982 update per symbol (src/kalman.c:85-141
driven from equalizer.c:25-58), a 159-step serial recursion per frame.
The blocked form processes ``B`` symbols with FROZEN coefficients (one
batched filter and error computation), then folds the block into ONE
information-form RLS update:

    R   <- lam^B * (R + Z^H Z) + (1 - lam^B) * E * I
    dw  =  solve(R + Z^H Z, Z^H e)        (L x L Cholesky, batched)

with ``lam = 1/(1+q)`` (the reference's per-step process-noise
inflation, kalman.c:62, 115).  Training filters ``z . coeff`` (no conj),
data ``w . conj(coeff)`` (equalizer.c:48-50 vs 69-71); both share the
window Gram matrix, R is tracked in the training domain and the data
update solves for conj(coeff).  The contractions are complex products in
true f32 (``device.require_true_f32`` on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import require_true_f32, resolve_device
from ..utils.linalg import chol_solve_hermitian
from .equalizer import _dibit, _slice


class BlockedEqState(NamedTuple):
    """Information-form blocked-RLS state (per channel or batch)."""
    r: torch.Tensor       # [.., L, L] c64 forgetting-weighted info matrix
    coeff: torch.Tensor   # [.., L] c64 equalizer taps


def blocked_eq_init(eq_length: int, E: float, batch_shape=(),
                    device=None) -> BlockedEqState:
    """kalman_reset equivalent: coeff = 0, R = E*I (kalman.c:42-55), on
    the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    eye = torch.eye(eq_length, dtype=torch.complex64, device=dev)
    return BlockedEqState(
        r=(E * eye).expand(*batch_shape, eq_length, eq_length).clone(),
        coeff=torch.zeros((*batch_shape, eq_length), dtype=torch.complex64,
                          device=dev))


def _filter(Z: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """sum_l Z[.., b, l] * coeff[.., l] -> [.., B]."""
    return torch.matmul(Z, coeff[..., None])[..., 0]


def _info_update(state: BlockedEqState, Z, e_vec, lam_B: float, E: float,
                 conj_domain: bool) -> BlockedEqState:
    """One blocked info-form update from windows Z [.., B, L] and
    frozen-coefficient errors e_vec [.., B]."""
    require_true_f32(Z.real)
    zh = Z.conj().transpose(-1, -2)
    A = torch.matmul(zh, Z)
    # R is tracked in the TRAIN domain; the data update solves for
    # conj(coeff), whose curvature is R's elementwise conjugate.
    r_dom = state.r.conj() if conj_domain else state.r
    S = r_dom + A
    b = torch.matmul(zh, e_vec[..., None])[..., 0]
    delta = chol_solve_hermitian(S, b)
    if conj_domain:
        delta = delta.conj()
    coeff = state.coeff + delta
    L = Z.shape[-1]
    eye = torch.eye(L, dtype=torch.complex64, device=Z.device)
    r_new = lam_B * S + (1.0 - lam_B) * E * eye
    if conj_domain:
        r_new = r_new.conj()
    return BlockedEqState(r=r_new.resolve_conj(), coeff=coeff)


def train_block(state: BlockedEqState, Z, refs, mask, lam_B: float,
                E: float, count_post: bool = False):
    """One frozen-coefficient training block.

    Z: [.., B, L] symbol windows; refs: [B] real preamble chips
    (train_eq's real reference, equalizer.c:45); mask: [B] f32 validity
    (the ragged tail).  Returns ``(new_state, match_count)``.  Matches
    count the sign agreement of the frozen-coefficient predictions
    (``count_post=True``, the first block, whose frozen coefficients are
    zero: of the post-update ones), not the reference's undershoot
    statistic (qpsk.c:117), as the JAX package documents.
    """
    val = _filter(Z, state.coeff)
    err = refs - val                      # conj(ref - val).real == real
    new_state = _info_update(state, Z * mask[..., None], err * mask, lam_B,
                             E, conj_domain=False)
    if count_post:
        val = _filter(Z, new_state.coeff)
    matches = ((val.real * refs > 0.0) * mask).sum(dim=-1)
    return new_state, matches.to(torch.int32)


def data_block(state: BlockedEqState, W, mask, lam_B: float, E: float,
               error_gain: float = 0.1):
    """One frozen-coefficient decision-directed block.

    W: [.., B, L] windows.  Filters with conj(coeff) (equalizer.c:71),
    slices hard QPSK decisions, updates in the conj domain with the x0.1
    decision-error damping (equalizer.c:81).  Returns ``(new_state,
    dibits [.., B], err_real_sum [..])``, the last the reference's EOF
    cost contribution (qpsk.c:227-231).
    """
    sym = _filter(W, state.coeff.conj())
    i_bit, q_bit, hard = _slice(sym)
    err = (hard - sym) * error_gain
    err_sum = (err.real * mask).sum(dim=-1)
    new_state = _info_update(state, W * mask[..., None], err * mask, lam_B,
                             E, conj_domain=True)
    return new_state, _dibit(i_bit, q_bit), err_sum
