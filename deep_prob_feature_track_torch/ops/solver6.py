"""Batched 6x6 damped normal-equation solves on the device.

Counterpart of ``deep_prob_feature_track_tpu/ops/solver6.py``: the damping,
the Cholesky solve of the tracker, its unrolled form and the general solve.
``cholesky_ex`` is used instead of ``cholesky``: the latter checks for
errors with a host sync in every Gauss-Newton iteration.
"""

from __future__ import annotations

import torch


def lev_mar_damp(
    JtWJ: torch.Tensor, damping: float = 1e-6, abs_floor: float = 1e-12
) -> torch.Tensor:
    """Trace-scaled diagonal damping ``H + (eps*trace(H) + floor)*I``; the
    absolute floor keeps the factorization finite when JtWJ is zero."""
    eye = torch.eye(6, dtype=JtWJ.dtype, device=JtWJ.device)
    trace = torch.diagonal(JtWJ, dim1=-2, dim2=-1).sum(-1)
    return JtWJ + (trace * damping + abs_floor)[..., None, None] * eye


def solve_chol(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = rhs`` for SPD ``H [B,6,6]``; ``rhs`` is [B,6] or [B,6,1]
    and the result has the same shape.  Where ``H`` is not positive
    definite in its dtype the solve is NaN on every device, as the JAX
    package's (``jnp.linalg.cholesky`` gives NaN there; the CPU's
    ``cholesky_ex`` would leave a partial factor and a finite answer)."""
    squeeze = rhs.ndim == H.ndim - 1
    b = rhs[..., None] if squeeze else rhs
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b, L).masked_fill((info != 0)[..., None, None], float("nan"))
    return x[..., 0] if squeeze else x


def solve_chol_unrolled(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """:func:`solve_chol` as a straight-line 6x6 Cholesky-Crout solve in
    elementwise ops over the batch (pivots floored at 1e-30 before their
    square root); ``rhs`` is [B,6] or [B,6,1]."""
    squeeze = rhs.ndim == H.ndim - 1
    b = rhs if squeeze else rhs[..., 0]
    n = 6
    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        inv_diag[j] = 1.0 / d
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_diag[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_diag[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_diag[i]
    out = torch.stack(x, dim=-1)
    return out if squeeze else out[..., None]


def solve_inverse(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``H^-1 rhs`` by a general LU solve (``torch.linalg.solve``), the
    original implementation's differentiable inverse; ``rhs`` is [B,6] or
    [B,6,1]."""
    squeeze = rhs.ndim == H.ndim - 1
    b = rhs[..., None] if squeeze else rhs
    x = torch.linalg.solve(H, b)
    return x[..., 0] if squeeze else x
