"""Warped feature-metric residuals: uncertainty-normalized (U_IC) and
plain (IC).

Counterpart of ``deep_prob_feature_track_tpu/solvers/residuals.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import warp as W


class ResidualOutput(NamedTuple):
    weighted_res: torch.Tensor  # [B,C,H,W] res/sigma, invalid -> 1e-6
    res: torch.Tensor           # [B,C,H,W] raw residual (unmasked)
    sigma: torch.Tensor         # [B,C,H,W] combined sigma
    invalid: torch.Tensor       # [B,1,H,W] bool, True where invalid


def compute_inverse_residuals(
    pose10, invD0, x0, sigma0, px, py, K, warp_op,
    remove_tru_sigma: bool = False, plain: bool = False,
):
    """Inverse-compositional residual: warp + occlusion + compose.

    The target inverse depth, features and sigma are warped in ONE gather
    of the stacked operand ``warp_op`` (:func:`build_inverse_warp_operand`).
    ``remove_tru_sigma`` also invalidates pixels where either sigma map is
    exactly at its batch-global min or max.

    :return: ``(ResidualOutput, u, v)``
    """
    u, v, inv_z = W.batch_warp_inverse_depth(px, py, invD0, pose10, K)
    invD1_w, f_r, sigma_r = W.warp_operand(warp_op[0], warp_op[1], u, v, plain=plain)

    occ = W.check_occ_prewarped(inv_z, invD1_w, u, v)
    res = f_r - x0
    sigma = torch.sqrt(sigma_r * sigma_r + sigma0 * sigma0)
    weighted = res / sigma
    if remove_tru_sigma:
        sigma_tru = (
            (sigma_r == sigma_r.amin())
            | (sigma_r == sigma_r.amax())
            | (sigma0 == sigma0.amin())
            | (sigma0 == sigma0.amax())
        )
        occ = occ | sigma_tru[:, 0:1]
    weighted = weighted.masked_fill(occ, 1e-6)
    return ResidualOutput(weighted, res, sigma, occ), u, v


def build_inverse_warp_operand(invD1, x1, sigma1):
    """Stacked channels-last operand ``[invD1 | x1 | sigma1]`` of the maps
    the U_IC iteration warps (loop-invariant: built once per level)."""
    return W.make_warp_operand([invD1, x1, sigma1])


def make_ic_operands(x1, invD1, samples: int = 1):
    """The channels-last operands of ``x1`` and ``invD1`` that the IC
    residual warps, one gather each, as the JAX package warps them; with
    ``samples`` > 1 each plane is repeated along the batch, sample-major
    (index ``s * B + b``), for the poses of the damping samples.  Built
    once per level."""
    return [W.make_warp_operand([m.repeat(samples, 1, 1, 1) if samples > 1 else m])
            for m in (x1, invD1)]


def warped_residual(pose10, invD0, x0, px, py, K, operands, plain: bool = False):
    """:func:`compute_warped_residual` on the operands of
    :func:`make_ic_operands`; with folded operands, every argument has
    their batch."""
    u, v, inv_z = W.batch_warp_inverse_depth(px, py, invD0, pose10, K)
    x1_warped = W.warp_operand(*operands[0], u, v, plain=plain)[0]
    invD1_warped = W.warp_operand(*operands[1], u, v, plain=plain)[0]
    occ = W.check_occ_prewarped(inv_z, invD1_warped, u, v)
    return (x1_warped - x0).masked_fill(occ, 1e-3), occ


def compute_warped_residual(pose10, invD0, invD1, x0, x1, px, py, K,
                            obj_mask0=None, obj_mask1=None, plain: bool = False):
    """Plain warped residual ``x1(w(x)) - x0`` of the IC track, 1e-3 where
    invalid.  ``x1`` and ``invD1`` (for the occlusion test) warp in one
    gather each, as in the JAX package.  Object masks are not ported.

    :return: ``(residuals [B,C,H,W], invalid [B,1,H,W])``
    """
    if obj_mask0 is not None or obj_mask1 is not None:
        raise NotImplementedError("object masks are not ported")
    return warped_residual(pose10, invD0, x0, px, py, K, make_ic_operands(x1, invD1),
                           plain=plain)
