"""Small dense linear algebra, unrolled
(``singlecarrier_tpu/utils/linalg.py``).

The equalizer's L x L (L = 5) hermitian positive-definite normal
equations are solved by an unrolled Cholesky: ~L^2/2 elementwise
operations over the batch, in the JAX package's order.  ``torch.linalg``
is not used: its batched tiny solves sum in another order, and on the
card they go through a solver library.
"""

from __future__ import annotations

import torch


def chol_solve_hermitian(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for hermitian positive-definite A.

    ``A``: [..., L, L] complex (hermitian PSD plus ridge); ``b``: [..., L]
    complex.  A = C C^H, then forward and back substitution; everything
    runs over the leading batch dims.
    """
    L = A.shape[-1]
    c = [[None] * L for _ in range(L)]      # c[i][j], i >= j, [...]-shaped
    for j in range(L):
        s = A[..., j, j].real
        for k in range(j):
            s = s - (c[j][k] * c[j][k].conj()).real
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        c[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, L):
            t = A[..., i, j]
            for k in range(j):
                t = t - c[i][k] * c[j][k].conj()
            c[i][j] = t * inv_d.to(t.dtype)

    y = [None] * L                          # forward: C y = b
    for i in range(L):
        t = b[..., i]
        for k in range(i):
            t = t - c[i][k] * y[k]
        y[i] = t / c[i][i]

    x = [None] * L                          # back: C^H x = y
    for i in reversed(range(L)):
        t = y[i]
        for k in range(i + 1, L):
            t = t - c[k][i].conj() * x[k]
        x[i] = t / c[i][i]
    return torch.stack(x, dim=-1)
