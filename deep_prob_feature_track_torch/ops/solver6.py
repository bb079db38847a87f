"""Batched 6x6 damped normal-equation solves on the device.

Counterpart of ``deep_prob_feature_track_tpu/ops/solver6.py``.
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
