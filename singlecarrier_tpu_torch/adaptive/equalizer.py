"""Adaptive linear equalizer driven by the square-root Kalman gain
(``singlecarrier_tpu/adaptive/equalizer.py``).

The reference's 5-tap feed-forward equalizer (src/equalizer.c): training
on a known reference symbol (equalizer.c:45-58) and decision-directed
data (equalizer.c:64-90) as pure step functions over explicit state,
batched over any leading (channel) shape; the modem layer loops them
over the symbols.

Replicated quirk (SURVEY.md quirk #7): the training filter is
``in * coeff`` with NO conjugation (equalizer.c:48-50), the data filter
``in * conj(coeff)`` (equalizer.c:69-71).  Descrambling is not done here
(the reference descrambles inside data_eq, equalizer.c:87): the
keystream is data-independent, so the modem XORs the dibits afterwards.
The filter sums run in ascending tap order, on both devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .kalman import KalmanState, kalman_init, kalman_update


class EqState(NamedTuple):
    """Equalizer + Kalman state for one (or a batch of) channel(s)."""
    kalman: KalmanState
    coeff: torch.Tensor   # [.., L] complex eq_coeff (kalman.c:19)


def eq_init(eq_length: int, batch_shape=(), device=None) -> EqState:
    """kalman_reset(): coeff = 0, u = 0, d = 1 (kalman.c:42-55), on the
    card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    return EqState(kalman=kalman_init(eq_length, batch_shape, dev),
                   coeff=torch.zeros((*batch_shape, eq_length),
                                     dtype=torch.complex64, device=dev))


def _dot(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_k x[..., k] * c[..., k], k ascending."""
    terms = x * c
    s = terms[..., 0]
    for k in range(1, terms.shape[-1]):
        s = s + terms[..., k]
    return s


def _slice(sym: torch.Tensor):
    """Hard QPSK decisions: (I bit, Q bit, the +-1 +-1j symbol)."""
    i_bit = sym.real < 0.0
    q_bit = sym.imag < 0.0
    hard = torch.complex(torch.where(i_bit, -1.0, 1.0),
                         torch.where(q_bit, -1.0, 1.0))
    return i_bit, q_bit, hard


def _dibit(i_bit: torch.Tensor, q_bit: torch.Tensor) -> torch.Tensor:
    """dibit = (I_bit << 1) | Q_bit, u8 (qpsk.c:268-271)."""
    return (i_bit.to(torch.uint8) << 1) | q_bit.to(torch.uint8)


def _update(state: EqState, x_win, error, E: float, q: float) -> EqState:
    """update_eq(): gain recompute + coefficient update (equalizer.c:25-40)."""
    kalman, gain, y = kalman_update(state.kalman, x_win, E, q)
    scaled = error * y                                # equalizer.c:35
    coeff = state.coeff + scaled[..., None] * gain.conj()   # eq.c:38
    return EqState(kalman=kalman, coeff=coeff)


def train_step(state: EqState, x_win: torch.Tensor, ref, E: float,
               q: float):
    """One training update; returns ``(new_state, real_error)``.

    Port of train_eq(in, index, ref) (equalizer.c:45-58): ``ref`` is a
    REAL scalar (or [..] tensor): the C prototype takes float, and the
    callers' complex preamble chip is truncated to its real part
    (qpsk.c:115-117).
    """
    val = _dot(x_win, state.coeff)                    # no conj (eq.c:48-50)
    error = (ref - val).conj()                        # equalizer.c:53
    return _update(state, x_win, error, E, q), error.real


def data_step(state: EqState, x_win: torch.Tensor, E: float, q: float,
              error_gain: float = 0.1):
    """One decision-directed update; returns ``(new_state, dibit,
    real_error)``.

    Port of data_eq(&bits, in, index) (equalizer.c:64-90) minus the
    in-place descramble.  dibit = (I_bit << 1) | Q_bit with I_bit =
    Re(sym) < 0, Q_bit = Im(sym) < 0 (qpsk.c:268-271).
    """
    sym = _dot(x_win, state.coeff.conj())             # eq.c:69-71
    i_bit, q_bit, hard = _slice(sym)
    error = (hard - sym) * error_gain                 # equalizer.c:81
    new_state = _update(state, x_win, error, E, q)
    return new_state, _dibit(i_bit, q_bit), error.real


def data_step_coherent(state: EqState, x_win: torch.Tensor, E: float,
                       q: float, error_gain: float = 0.1):
    """Phase-unambiguous decision-directed update.

    Slices in the training-consistent domain: training drives
    ``sum(win * coeff) -> p`` (real +-1) for chips ``g*(1+j)*p``, so a
    data symbol s gives ``raw = s*(1-j)/2`` and ``raw * (1+j) = s``; the
    known-phase preamble pins the rotation the reference's conj(coeff)
    slicer leaves ambiguous (equalizer.c:49 vs 71).  The error is formed
    in the raw domain.  Returns ``(new_state, dibit, real_error)``.
    """
    raw = _dot(x_win, state.coeff)
    sym = raw * (1.0 + 1.0j)
    i_bit, q_bit, hard = _slice(sym)
    desired_raw = hard * (0.5 - 0.5j)                 # hard / (1+j)
    error = (desired_raw - raw) * error_gain
    new_state = _update(state, x_win, error, E, q)
    return new_state, _dibit(i_bit, q_bit), error.real


def data_step_nlms(state: EqState, x_win: torch.Tensor, mu: float = 0.5,
                   eps: float = 1e-3):
    """Decision-directed normalized LMS step; the Kalman is left as it
    is (its q inflation diverges over runs longer than the ~159 updates
    the reference chains between resets, kalman.c:62).  Slices as
    :func:`data_step_coherent`.  Returns ``(new_state, dibit,
    |error|)``."""
    raw = _dot(x_win, state.coeff)
    sym = raw * (1.0 + 1.0j)
    i_bit, q_bit, hard = _slice(sym)
    desired_raw = hard * (0.5 - 0.5j)
    error = desired_raw - raw
    energy = x_win.real ** 2 + x_win.imag ** 2
    norm = energy[..., 0]
    for k in range(1, energy.shape[-1]):
        norm = norm + energy[..., k]
    norm = eps + norm
    coeff = state.coeff + (mu / norm)[..., None] * error[..., None] \
        * x_win.conj()
    return (EqState(kalman=state.kalman, coeff=coeff), _dibit(i_bit, q_bit),
            error.abs())
