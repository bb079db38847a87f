"""IC Gauss-Newton Jacobians with factored (Jacobian-free) JtWJ reductions.

Counterpart of ``deep_prob_feature_track_tpu/solvers/jacobians.py``.  The
chained Jacobian has rank-2 structure per pixel,
``J[b,c,p,:] = alpha[b,c,p] u[b,p,:] + beta[b,c,p] v[b,p,:]``, so it is
never materialized: ``jtj_jtr`` reduces the factors directly, through
kernel K6 on CUDA tensors (``ops/kernels/jtj.py``), differentiably.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.image import sobel_gradients
from ..ops.kernels.jtj import FusedJtJ, fused_jtj_jtr, jtj_jtr_ref


def compute_jacobian_warping(p_invdepth, K, px, py):
    """Analytic 2x6 pixel-to-twist Jacobian at the origin, twist [rot, trs].

    :return: ``(Jx_p, Jy_p)`` each ``[B, H*W, 6]``
    """
    B = p_invdepth.shape[0]
    x = px.reshape(B, -1)
    y = py.reshape(B, -1)
    invd = p_invdepth.reshape(B, -1)
    xy = x * y
    O = torch.zeros_like(x)
    dx_dp = torch.stack([-xy, 1 + x * x, -y, invd, O, -invd * x], dim=-1)
    dy_dp = torch.stack([-1 - y * y, xy, x, O, invd, -invd * y], dim=-1)
    fx = K[:, 0][:, None, None]
    fy = K[:, 1][:, None, None]
    return dx_dp * fx, dy_dp * fy


class FactoredJtJ(NamedTuple):
    """Per-pixel rank-2 factors of the chained Jacobian."""

    alpha: torch.Tensor  # [B,C,H,W] x-gradient coefficient
    beta: torch.Tensor   # [B,C,H,W] y-gradient coefficient
    u: torch.Tensor      # [B,HW,6] warp Jacobian in x
    v: torch.Tensor      # [B,HW,6] warp Jacobian in y
    sign: float          # +1 forward / -1 inverse-compositional


def jtj_jtr(fac: FactoredJtJ, residual: torch.Tensor, plain: bool = False):
    """``(JtWJ [B,6,6], JtWr [B,6,1])`` of ``J = sign*(alpha u + beta v)``.

    K6 on CUDA tensors, its plain version on CPU tensors or with
    ``plain=True``; under autograd the closed-form VJP of ``FusedJtJ``.
    """
    B, C, H, W = residual.shape
    args = (
        fac.alpha.reshape(B, C, H * W).contiguous(),
        fac.beta.reshape(B, C, H * W).contiguous(),
        residual.reshape(B, C, H * W).contiguous(),
        fac.u.contiguous(),
        fac.v.contiguous(),
    )
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedJtJ.apply(*args, fac.sign, plain)
    return (jtj_jtr_ref if plain else fused_jtj_jtr)(*args, sign=fac.sign)


class UICPrecomp(NamedTuple):
    """Template-side precomputations of the U_IC solver (one per level)."""

    gxf: torch.Tensor  # [B,C,H,W] normalized Sobel d(f0)/dx
    gyf: torch.Tensor
    gxs: torch.Tensor  # [B,C,H,W] normalized Sobel d(sigma0)/dx
    gys: torch.Tensor
    u: torch.Tensor    # [B,HW,6]
    v: torch.Tensor


def precompute_uic(invD0, f0, sigma0, px, py, K) -> UICPrecomp:
    """Template gradients + warp Jacobians for the inverse track."""
    gxf, gyf = sobel_gradients(f0)
    gxs, gys = sobel_gradients(sigma0)
    u, v = compute_jacobian_warping(invD0, K, px, py)
    return UICPrecomp(gxf, gyf, gxs, gys, u, v)


def uic_factors(pre: UICPrecomp, res, sigma, sigma0) -> FactoredJtJ:
    """Per-iteration Jacobian coefficients of the uncertainty-normalized
    inverse residual:
    ``J = -(-grad_f0/sigma - res * sigma0 * grad_sigma0 / sigma^3)``."""
    sigma3 = sigma * sigma * sigma
    scale = res * sigma0 / sigma3
    alpha = -pre.gxf / sigma - scale * pre.gxs
    beta = -pre.gyf / sigma - scale * pre.gys
    return FactoredJtJ(alpha=alpha, beta=beta, u=pre.u, v=pre.v, sign=-1.0)
