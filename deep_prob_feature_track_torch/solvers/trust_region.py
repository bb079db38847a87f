"""Trust-region Gauss-Newton level solves of the U_IC, IC and ICP tracks.

Counterpart of ``deep_prob_feature_track_tpu/solvers/trust_region.py``:
``tr_uic_level`` (with the fused ICP term), ``tr_ic_level``,
``tr_icp_level`` (inverse and forward), ``tr_icp_point_level``, the pose
updates and ``direct_solve`` for ``kind="nodamping"``.  A U_IC iteration
runs kernel K1 once for its feature warp, once more for the ICP warp with
the fused ICP term, and K6 once; an IC iteration runs K1 twice (the feature
and the occlusion depth, as the JAX package warps them), an ICP iteration
once.  Where ``use_tiles`` holds, K4 takes K1's place; under autograd K2
(K5) does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import warp as W
from ..geometry.lie import compose, exp_so3
from ..ops.image import compute_normal
from ..ops.solver6 import lev_mar_damp, solve_chol
from . import icp as icp_mod
from .jacobians import jtj_jtr, jtr_only, precompute_ic, precompute_uic, uic_factors
from .residuals import (
    build_inverse_warp_operand,
    compute_inverse_residuals,
    compute_warped_residual,
)


def inverse_update_pose(H, rhs, pose):
    """Inverse-compositional update: right-compose ``exp(xi)^{-1}``."""
    xi = solve_chol(H, rhs[..., 0])  # [B,6]
    d_R = exp_so3(-xi[:, :3])
    d_t = -torch.einsum("bij,bj->bi", d_R, xi[:, 3:])
    R, t = pose
    return compose(R, t, d_R, d_t)


def forward_update_pose(H, rhs, pose):
    """Forward-compositional update ``pose o exp(xi)``."""
    xi = solve_chol(H, rhs[..., 0])
    R, t = pose
    return compose(R, t, exp_so3(xi[:, :3]), xi[:, 3:])


class DirectSolver(NamedTuple):
    """The trust-region solve: ``kind="nodamping"`` is LM-damped
    Gauss-Newton; ``"resvol"`` (the learned damping) is not ported."""

    kind: str = "nodamping"
    direction: str = "inverse"  # inverse | forward


def direct_solve(solver: DirectSolver, JtWJ, JtR, pose):
    if solver.kind != "nodamping":
        raise NotImplementedError(f"DirectSolver(kind={solver.kind!r}) is not ported")
    update = forward_update_pose if solver.direction == "forward" else inverse_update_pose
    return update(lev_mar_damp(JtWJ), JtR, pose)


def tr_uic_level(
    pose, x0, x1, invD0, invD1, K, sigma0, sigma1,
    depth0=None, depth1=None, w_icp=None,
    max_iter: int = 3, remove_tru_sigma: bool = False,
    icp_sigma: icp_mod.ICPSigmaModel = icp_mod.ICPSigmaModel(), plain: bool = False,
):
    """One pyramid level of the U_IC solver, ``max_iter`` GN iterations.

    Given ICP weights ``w_icp`` [B,1,H,W] (the JAX function's
    ``combine_icp``), the inverse point-to-plane ICP system of the depth
    maps ``depth0/1``, weighted by them, is added to the feature system
    every iteration.  The caller makes ``w_icp``: the JAX function has
    ``scale_fn`` compute it from the residuals at the incoming pose, and the
    one ported scale, ``ScaleNet("None")``, reads only their shape (under
    ``jit`` XLA drops those residuals too).

    :param plain: use the kernels' plain versions on any device
    :return: ``(pose, weights, JtWJ)``: the weights are ``w_icp``, or
        ones without it; JtWJ is the last iteration's system
    """
    B, _, H, W_ = x0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    pre = precompute_uic(invD0, x0, sigma0, px, py, K)
    warp_op = build_inverse_warp_operand(invD1, x1, sigma1)

    combine_icp = w_icp is not None
    if combine_icp:
        vertex0 = W.compute_vertex(depth0, px, py)
        vertex1 = W.compute_vertex(depth1, px, py)
        normal1 = compute_normal(vertex1)
        icp_op = W.make_warp_operand([vertex1, normal1])  # loop-invariant

    JtWJ = torch.zeros((B, 6, 6), dtype=x0.dtype, device=x0.device)
    for _ in range(max_iter):
        out, _, _ = compute_inverse_residuals(
            pose, invD0, x0, sigma0, px, py, K, warp_op,
            remove_tru_sigma=remove_tru_sigma, plain=plain,
        )
        fac = uic_factors(pre, out.res, out.sigma, sigma0)
        JtWJ, JtR = jtj_jtr(fac, out.weighted_res, plain=plain)
        if combine_icp:
            icp_res, icp_J, _ = icp_mod.icp_residuals_inverse(
                vertex0, vertex1, normal1, pose, K, sigma_model=icp_sigma, warp_op=icp_op,
                plain=plain)
            icp_JtJ, icp_JtR = icp_mod.icp_jtj_jtr(w_icp.reshape(B, H * W_, 1) * icp_J,
                                                   w_icp * icp_res)
            JtWJ = JtWJ + icp_JtJ
            JtR = JtR + icp_JtR
        pose = inverse_update_pose(lev_mar_damp(JtWJ), JtR, pose)
    return pose, (w_icp if combine_icp else torch.ones_like(x0)), JtWJ


def tr_ic_level(pose, x0, x1, invD0, invD1, K, mest_fn, solver: DirectSolver,
                w_prior=None, max_iter: int = 3, plain: bool = False):
    """One pyramid level of the plain IC track: the template Jacobian and
    the M-estimator weights come from the residual at the incoming pose;
    each iteration solves, then takes the residual at the new pose.  The
    last iteration's new residual is dead work (the JAX loop carries it out
    and drops it), and is not computed.

    :return: ``(pose, weights, JtWJ)``
    """
    B, _, H, W_ = x0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    pre = precompute_ic(invD0, x0, px, py, K)
    residuals, _ = compute_warped_residual(pose, invD0, invD1, x0, x1, px, py, K, plain=plain)
    weights = mest_fn(residuals, x0, x1, w_prior)
    JtWJ, _ = jtj_jtr(pre.fac, residuals, weights=weights)
    for i in range(max_iter):
        JtR = jtr_only(pre.fac, residuals, weights=weights)
        pose = direct_solve(solver, JtWJ, JtR, pose)
        if i + 1 < max_iter:
            residuals, _ = compute_warped_residual(pose, invD0, invD1, x0, x1, px, py, K,
                                                   plain=plain)
    return pose, weights, JtWJ


def tr_icp_level(pose, depth0, depth1, K, w_prior=None, max_iter: int = 3,
                 direction: str = "inverse",
                 sigma_model: icp_mod.ICPSigmaModel = icp_mod.ICPSigmaModel(baseline=1.0),
                 plain: bool = False):
    """One level of the stand-alone point-to-plane ICP track, inverse- or
    forward-compositional.

    :return: ``(pose, weights, JtJ)``; the weights are ones
    """
    B, _, H, W_ = depth0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    vertex0 = W.compute_vertex(depth0, px, py)
    vertex1 = W.compute_vertex(depth1, px, py)
    normal1 = compute_normal(vertex1)
    icp_op = W.make_warp_operand([vertex1, normal1])
    residual_fn, update = {
        "inverse": (icp_mod.icp_residuals_inverse, inverse_update_pose),
        "forward": (icp_mod.icp_residuals_forward, forward_update_pose),
    }[direction]
    JtJ = torch.zeros((B, 6, 6), dtype=depth0.dtype, device=depth0.device)
    for _ in range(max_iter):
        res, J, _ = residual_fn(vertex0, vertex1, normal1, pose, K, sigma_model=sigma_model,
                                warp_op=icp_op, plain=plain)
        JtJ, JtR = icp_mod.icp_jtj_jtr(J, res)
        pose = update(lev_mar_damp(JtJ), JtR, pose)
    return pose, torch.ones_like(depth0), JtJ


def tr_icp_point_level(pose, depth0, depth1, K, max_iter: int = 10, dist_thr: float = 0.05,
                       plain: bool = False):
    """One level of forward-compositional point-to-point ICP with
    projective association.

    :return: ``(pose, JtJ)``
    """
    B, _, H, W_ = depth0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    vertex0 = W.compute_vertex(depth0, px, py)
    vertex1 = W.compute_vertex(depth1, px, py)
    JtJ = torch.zeros((B, 6, 6), dtype=depth0.dtype, device=depth0.device)
    for _ in range(max_iter):
        res, J, _ = icp_mod.icp_residuals_point2point(vertex0, vertex1, pose, K,
                                                      dist_thr=dist_thr, plain=plain)
        JtJ, JtR = icp_mod.icp_p2p_jtj_jtr(J, res)
        pose = forward_update_pose(lev_mar_damp(JtJ), JtR, pose)
    return pose, JtJ
