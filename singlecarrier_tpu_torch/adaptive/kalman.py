"""Square-root (UD-factorized) Kalman/RLS gain estimator
(``singlecarrier_tpu/adaptive/kalman.py``).

The reference's Hsu-1982 square-root Kalman update (src/kalman.c:85-141)
as a pure function of explicit state ``{u, d}``, over any leading batch
(channel) shape.  Within outer step j every u[i][j] update reads the
gain as it stood at the start of step j, and every gain update reads
the ORIGINAL column u[:, j] (kalman.c:125-140), so each j-step is two
masked rank-1 vector operations.  u stays strictly upper triangular.

Every sum here is written out in ascending order (``f``, the prefix sums
``a``), so the card adds in the order the CPU does: the recursion
amplifies a last-bit difference over its 159 steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import on_device, resolve_device


class KalmanState(NamedTuple):
    """UD factors: u strictly-upper [.., L, L] c64, d diagonal [.., L] f32."""
    u: torch.Tensor
    d: torch.Tensor


def kalman_init(eq_length: int, batch_shape=(), device=None) -> KalmanState:
    """kalman_reset(): u = 0, d = 1 (kalman.c:42-55), on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    return KalmanState(
        u=torch.zeros((*batch_shape, eq_length, eq_length),
                      dtype=torch.complex64, device=dev),
        d=torch.ones((*batch_shape, eq_length), dtype=torch.float32,
                     device=dev))


def kalman_update(state: KalmanState, x_win: torch.Tensor, E: float,
                  q: float):
    """One gain computation; returns ``(new_state, gain, y)``.

    Port of kalman_calculate(x, index) (kalman.c:85-141) with
    ``x_win = x[index : index + L]`` ([.., L] complex).  ``gain`` is the
    fully updated kalman_gain [.., L] (as the coefficient update consumes
    it, equalizer.c:35-39), ``y`` the final kalman_y = 1/(a[L-1] + ht)
    [..] f32 (kalman.c:130).
    """
    u, d = state
    L = x_win.shape[-1]
    cx = x_win.conj_physical()

    # 6.2/6.3: f[j] = conj(x[j]) + sum_{i} u[i][j] conj(x[i]), ascending i
    # (kalman.c:89-100; u is strictly upper, so the rows i >= j add 0).
    rows = (u * cx[..., :, None]).unbind(-2)
    s = rows[0]
    for i in range(1, L):
        s = s + rows[i]
    f = cx + s

    # 6.4: initial gain g = f * d (kalman.c:105-107).
    gain = f * d

    # 6.5/6.6: a[j] = E + sum_{k<=j} Re(g[k] conj(f[k])), the sum
    # ascending (kalman.c:109-113).
    prods = (gain.real * f.real + gain.imag * f.imag).unbind(-1)
    c = [prods[0]]
    for j in range(1, L):
        c.append(c[-1] + prods[j])
    a = E + torch.stack(c, dim=-1)

    hq = 1.0 + q                      # 6.7 (kalman.c:115)
    ht = a[..., L - 1] * q            # (kalman.c:117)
    aht = a + ht[..., None]
    # 6.19, 6.22: y[j] = 1/(a[j] + ht) (kalman.c:119, 130); 6.20-6.21:
    # B[0] = E + ht, B[j] = a[j-1] + ht; 6.13: d'[j] = d[j] hq B[j] y[j]
    # (kalman.c:121, 127-129).
    y = 1.0 / aht
    B = torch.cat([(E + ht)[..., None], aht[..., :-1]], dim=-1)
    new_d = d * hq * B * y
    h = -f[..., 1:] * y[..., :-1]     # 6.11: h[j] = -f[j] y[j-1]

    # 6.15/6.16, one masked rank-1 pair per j (kalman.c:125-140):
    # u[i][j] += h[j] conj(gain[i]) for i < j, the gain as of the step's
    # start (kalman.c:137); then gain[i] += gain[j] conj(u_old[i][j])
    # (kalman.c:138), whose rows i >= j are 0.
    cols = list(u.unbind(-1))
    cols_conj = u.conj_physical().unbind(-1)
    mask = on_device(_strictly_above, (L,), u.device)
    for j in range(1, L):
        upd = h[..., j - 1, None] * gain.conj_physical()
        cols[j] = cols[j] + torch.where(mask[j], upd, 0.0)
        gain = gain + gain[..., j, None] * cols_conj[j]

    return (KalmanState(u=torch.stack(cols, dim=-1), d=new_d), gain,
            y[..., L - 1])


def _strictly_above(L: int) -> np.ndarray:
    """[L, L] bool: row j marks the rows i < j of column j."""
    return np.tril(np.ones((L, L), bool), -1)
