"""Trust-region Gauss-Newton level solves of the U_IC, IC, U_FC and ICP
tracks.

Counterpart of ``deep_prob_feature_track_tpu/solvers/trust_region.py``:
``tr_uic_level`` (with the fused ICP term), ``tr_ic_level``,
``tr_ufc_level`` (forward-compositional, with uncertainty),
``tr_icp_level`` (inverse and forward), ``tr_icp_point_level``, the pose
updates and ``direct_solve`` for ``kind="nodamping"`` and ``"resvol"`` (the
learned damping of ``Direct-ResVol``).  A U_IC iteration runs kernel K1
once for its feature warp, once more for the ICP warp with the fused ICP
term, and K6 once (a learned ICP scale reads iteration 0's residuals and
launches nothing of its own); an IC residual runs K1 twice (the feature and the
occlusion depth, as the JAX package warps them), and a ``resvol`` solve
twice more for the residuals of all its damping samples at once; a U_FC
iteration runs K1 once, on one operand of the target depth, features,
sigma and their gradients (C=28 with a 1-channel sigma), and weighs its
system in tensor ops (no K6); an ICP iteration runs K1 once.  Where
``use_tiles`` holds, K4 takes K1's place; under autograd K2 (K5) does.
Object masks ride in the U_IC, fused-ICP and U_FC operands as one more
channel (no more launches); an IC residual warps the frame-1 mask in a
gather of its own (three K1 a residual), and the stand-alone ICP track and
the U_FC residual ignore the masks, as the JAX functions do.

The ``tr_*_residual`` functions give each track's average residual at a
fixed pose (``residuals.compute_avg_loss``), for the convergence-basin
study: one K1 for U_IC, U_FC and ICP, two for U_IC with the ICP term and
for IC (whose learned M-estimator may warp more).

A training mode of the level solves, off by default: ``remat`` runs each
Gauss-Newton iteration under a checkpoint (:func:`_iterate`, the JAX
package's ``DPFT_TRAIN_LOOP=scan_remat``), so the backward recomputes the
iteration (its K2/K5 and K6 launch again) instead of keeping its
activations.  The JAX package can checkpoint only
loops whose body applies no bound flax module, and unrolls the IC loop
with a damping MLP and the U_FC loop with a learned M-estimator; a
PyTorch replay runs the same ops again, so every loop here takes it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..geometry import warp as W
from ..geometry.lie import compose, exp_so3
from ..ops.image import compute_normal, sobel_gradients
from ..ops.solver6 import lev_mar_damp, solve_chol
from ..utils.remat import checkpointed
from . import icp as icp_mod
from .jacobians import (
    FactoredJtJ,
    jtj_jtr,
    jtr_only,
    precompute_ic,
    precompute_uic,
    uic_factors,
)
from .residuals import (
    build_inverse_warp_operand,
    compute_avg_loss,
    compute_inverse_residuals,
    compute_warped_residual,
    make_ic_operands,
    warped_residual,
)


def _iterate(body, carry, max_iter: int, remat: bool):
    """``carry = body(i, carry)`` for ``i < max_iter``: the Gauss-Newton
    loop of every level solve (the JAX ``run_gn_iterations``); with
    ``remat`` each iteration runs under a checkpoint (``utils/remat.py``)."""
    for i in range(max_iter):
        carry = checkpointed(body, i, carry, enabled=remat)
    return carry


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
    Gauss-Newton; ``"resvol"`` regresses a per-axis damping with
    ``damping_mlp`` from the residual volume of ``samples`` trial solves."""

    kind: str = "nodamping"  # nodamping | resvol
    direction: str = "inverse"  # inverse | forward
    samples: int = 10
    damping_mlp: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@lru_cache(maxsize=None)
def _lambdas(samples: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The damping samples ``10^linspace(-5, 5, samples)`` [S] with the
    values of the JAX package's jitted ``jnp.logspace(-5, 5, samples,
    dtype)``: XLA computes the linspace as ``-5 (1 - i r) + i (5 r)``,
    ``r = 1/(S-1)``, in the dtype, ending on 5, and the power rounded from
    float64 (``torch.logspace`` differs by up to 4.4e-7 relative).  Made
    outside inference mode, so that a training forward may read it too."""
    ftype = np.float32 if dtype == torch.float32 else np.float64
    lin = np.full(1, -5.0, ftype)
    if samples > 1:
        r = ftype(1.0) / ftype(samples - 1)
        i = np.arange(samples - 1, dtype=ftype)
        lin = np.append(ftype(-5.0) * (ftype(1.0) - i * r) + i * (ftype(5.0) * r), ftype(5.0))
    with torch.inference_mode(False):
        return torch.from_numpy((10.0 ** lin.astype(np.float64)).astype(ftype)).to(device)


def _resvol_hessian(solver: DirectSolver, JtWJ, JtR, pose, residual_fn, jtr_fn):
    """The ``Direct-ResVol`` Hessian ``JtWJ + diag(damp) + eps I``.

    The S trial solves ``(JtWJ + lambda_s diag(JtWJ) + eps I) xi = JtR``
    (always inverse-compositional, as in the JAX package) run folded into
    the batch, sample-major: ``residual_fn`` takes the S*B poses in one call
    and ``jtr_fn`` reduces the S*B residuals to ``J^T W r``.  The damping
    MLP reads ``[JtR_vol (index i*S + s), JtWJ flattened]``.
    """
    B = JtWJ.shape[0]
    S = solver.samples
    eye = torch.eye(6, dtype=JtWJ.dtype, device=JtWJ.device)
    diagJtJ = eye * JtWJ
    trace = torch.diagonal(JtWJ, dim1=-2, dim2=-1).sum(-1)
    epsilon = (trace * 1e-6)[:, None, None] * eye
    lam = _lambdas(S, JtWJ.dtype, JtWJ.device)[:, None, None, None]
    Hs = (JtWJ + lam * diagJtJ + epsilon).reshape(S * B, 6, 6)
    R, t = pose
    pose_s = inverse_update_pose(Hs, JtR.repeat(S, 1, 1), (R.repeat(S, 1, 1), t.repeat(S, 1)))
    JtR_vol = jtr_fn(residual_fn(pose_s))  # [S*B,6,1]
    JtR_flat = JtR_vol.reshape(S, B, 6).permute(1, 2, 0).reshape(B, 6 * S)
    damp = solver.damping_mlp(torch.cat([JtR_flat, JtWJ.reshape(B, 36)], dim=1))  # [B,6]
    return JtWJ + (eye * damp[:, :, None] + epsilon)


def _update(solver: DirectSolver, H, JtR, pose):
    """The pose update of ``solver.direction``, without its damping."""
    if solver.direction == "forward":
        return forward_update_pose(H, JtR, pose)
    return inverse_update_pose(H, JtR, pose)


def direct_solve(solver: DirectSolver, JtWJ, JtR, pose, residual_fn=None, jtr_fn=None):
    """One damped update of ``pose``; ``kind="resvol"`` needs the residual
    of S*B folded poses (``residual_fn``) and its reduction (``jtr_fn``)."""
    if solver.kind == "resvol":
        if residual_fn is None or jtr_fn is None or solver.damping_mlp is None:
            raise ValueError("DirectSolver(kind='resvol') needs damping_mlp, residual_fn "
                             "and jtr_fn")
        H = _resvol_hessian(solver, JtWJ, JtR, pose, residual_fn, jtr_fn)
    elif solver.kind == "nodamping":
        H = lev_mar_damp(JtWJ)
    else:
        raise ValueError(f"unknown DirectSolver kind {solver.kind!r}")
    return _update(solver, H, JtR, pose)


def tr_uic_level(
    pose, x0, x1, invD0, invD1, K, sigma0, sigma1,
    depth0=None, depth1=None, obj_mask0=None, obj_mask1=None,
    max_iter: int = 3, remove_tru_sigma: bool = False,
    icp_sigma: icp_mod.ICPSigmaModel = icp_mod.ICPSigmaModel(), plain: bool = False,
    scale_fn=None, w_prior=None, remat: bool = False,
):
    """One pyramid level of the U_IC solver, ``max_iter`` GN iterations.

    With a ``scale_fn`` (the JAX function's ``combine_icp``), the inverse
    point-to-plane ICP system of the depth maps ``depth0/1`` is added to
    the feature system every iteration, weighted by ``scale_fn(icp_res,
    feature_res, w_prior)`` [B,1,H,W] (a ``ScaleNet``) of the first
    iteration's residuals at the incoming pose: the weighted feature
    residual and the ICP residual that iteration 0 solves with, computed
    once, so the scale costs no gather of its own.  The weights are reused for all
    ``max_iter`` iterations and returned as the chained prior weights.  The object masks ``obj_mask0/1``
    [B,1,H,W] (bool) go to every feature residual and to every ICP
    residual: the frame-1 mask rides in each operand as one more channel
    (C=11 for the feature operand of ``feature``, 7 for the ICP one), so
    the launches stay one gather per warp.

    :param plain: use the kernels' plain versions on any device
    :param remat: checkpoint each iteration (:func:`_iterate`)
    :return: ``(pose, weights, JtWJ)``: the weights are the ICP weights,
        or ones without them; JtWJ is the last iteration's system
    """
    B, _, H, W_ = x0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    pre = precompute_uic(invD0, x0, sigma0, px, py, K)
    warp_op = build_inverse_warp_operand(invD1, x1, sigma1, obj_mask1)

    def feature_residual(p):
        return compute_inverse_residuals(
            p, invD0, x0, sigma0, px, py, K, warp_op, obj_mask0=obj_mask0,
            remove_tru_sigma=remove_tru_sigma, plain=plain)[0]

    combine_icp = scale_fn is not None
    if combine_icp:
        vertex0 = W.compute_vertex(depth0, px, py)
        vertex1 = W.compute_vertex(depth1, px, py)
        normal1 = compute_normal(vertex1)
        icp_op = icp_mod.icp_operand(vertex1, normal1, obj_mask1)  # loop-invariant

        def icp_residual(p):
            return icp_mod.icp_residuals_inverse(
                vertex0, vertex1, normal1, p, K, obj_mask0, obj_mask1, sigma_model=icp_sigma,
                warp_op=icp_op, plain=plain)

        first = (feature_residual(pose), icp_residual(pose))
        w_icp = scale_fn(first[1][0], first[0].weighted_res, w_prior)

    def iteration(i, carry):
        pose = carry[0]
        out = first[0] if i == 0 and combine_icp else feature_residual(pose)
        fac = uic_factors(pre, out.res, out.sigma, sigma0)
        JtWJ, JtR = jtj_jtr(fac, out.weighted_res, plain=plain)
        if combine_icp:
            icp_res, icp_J, _ = first[1] if i == 0 else icp_residual(pose)
            icp_JtJ, icp_JtR = icp_mod.icp_jtj_jtr(w_icp.reshape(B, H * W_, 1) * icp_J,
                                                   w_icp * icp_res)
            JtWJ = JtWJ + icp_JtJ
            JtR = JtR + icp_JtR
        return inverse_update_pose(lev_mar_damp(JtWJ), JtR, pose), JtWJ

    JtWJ = torch.zeros((B, 6, 6), dtype=x0.dtype, device=x0.device)
    pose, JtWJ = _iterate(iteration, (pose, JtWJ), max_iter, remat)
    return pose, (w_icp if combine_icp else torch.ones_like(x0)), JtWJ


def tr_uic_residual(pose, x0, x1, invD0, invD1, K, sigma0, sigma1, depth0=None, depth1=None,
                    obj_mask0=None, obj_mask1=None, remove_tru_sigma: bool = False,
                    plain: bool = False, scale_fn=None, w_prior=None):
    """The U_IC track's average residual at ``pose`` [B]; with ICP weights
    (``scale_fn(icp_res, feature_res, w_prior)`` of the two residuals at
    ``pose``) the weighted inverse point-to-plane residual of
    ``depth0/1`` (default ICP sigma model) joins it, over the pixels valid
    in both.  The object masks reach the feature residual alone: the ICP
    term takes none, as in the JAX function."""
    B, _, H, W_ = x0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    out, _, _ = compute_inverse_residuals(
        pose, invD0, x0, sigma0, px, py, K,
        build_inverse_warp_operand(invD1, x1, sigma1, obj_mask1), obj_mask0=obj_mask0,
        remove_tru_sigma=remove_tru_sigma, plain=plain)
    if scale_fn is None:
        return compute_avg_loss([out.weighted_res], out.invalid)
    vertex0 = W.compute_vertex(depth0, px, py)
    vertex1 = W.compute_vertex(depth1, px, py)
    icp_res, _, icp_occ = icp_mod.icp_residuals_inverse(
        vertex0, vertex1, compute_normal(vertex1), pose, K, sigma_model=icp_mod.ICPSigmaModel(),
        plain=plain)
    w_icp = scale_fn(icp_res, out.weighted_res, w_prior)
    return compute_avg_loss([out.weighted_res, w_icp * icp_res], out.invalid | icp_occ)


def tr_ic_residual(pose, x0, x1, invD0, invD1, K, mest_fn, w_prior=None, obj_mask0=None,
                   obj_mask1=None, plain: bool = False):
    """The IC track's average M-estimator-weighted residual at ``pose`` [B],
    with both object masks."""
    B, _, H, W_ = x0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    residuals, occ = compute_warped_residual(pose, invD0, invD1, x0, x1, px, py, K,
                                             obj_mask0, obj_mask1, plain=plain)
    weights = mest_fn(residuals, x0, x1, w_prior)
    return compute_avg_loss([weights * residuals], occ)


def tr_ic_level(pose, x0, x1, invD0, invD1, K, mest_fn, solver: DirectSolver,
                w_prior=None, obj_mask0=None, obj_mask1=None, max_iter: int = 3,
                plain: bool = False, remat: bool = False):
    """One pyramid level of the IC track: the template Jacobian and the
    M-estimator weights come from the residual at the incoming pose; each
    iteration solves, then takes the residual at the new pose.  The last
    iteration's new residual is dead work (the JAX loop carries it out and
    drops it), and is not computed; its ``resvol`` damping samples are.
    The samples' operands are folded once per level.

    The first residual takes both object masks; the residuals of the
    iterations and of the damping samples take ``obj_mask1`` alone, as in
    the JAX function.  The frame-1 mask warps in a gather of its own (one
    more K1 a residual).  ``remat`` as in :func:`tr_uic_level`.

    :return: ``(pose, weights, JtWJ)``
    """
    B, _, H, W_ = x0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    pre = precompute_ic(invD0, x0, px, py, K)
    operands = make_ic_operands(x1, invD1, obj_mask1=obj_mask1)
    residuals, _ = warped_residual(pose, invD0, x0, px, py, K, operands, obj_mask0,
                                   plain=plain)
    weights = mest_fn(residuals, x0, x1, w_prior)
    JtWJ, _ = jtj_jtr(pre.fac, residuals, weights=weights)
    sample_fns = ()
    if solver.kind == "resvol":
        S = solver.samples
        folded = [t.repeat(S, *[1] * (t.ndim - 1)) for t in (invD0, x0, px, py, K)]
        sample_ops = make_ic_operands(x1, invD1, S, obj_mask1)

        def residual_fn(poses):
            return warped_residual(poses, *folded, sample_ops, plain=plain)[0]

        def jtr_fn(res):
            return jtr_only(pre.fac, res, weights=weights)

        sample_fns = (residual_fn, jtr_fn)
    def iteration(i, carry):
        pose, residuals = carry
        JtR = jtr_only(pre.fac, residuals, weights=weights)
        pose = direct_solve(solver, JtWJ, JtR, pose, *sample_fns)
        if i + 1 < max_iter:
            residuals, _ = warped_residual(pose, invD0, x0, px, py, K, operands, plain=plain)
        return pose, residuals

    pose, _ = _iterate(iteration, (pose, residuals), max_iter, remat)
    return pose, weights, JtWJ


def _warp_forward_depth(dpt0, pose, K, dpt_thr: float = 1e-6):
    """Forward warp of raw depth with its analytic coordinate Jacobians:
    back-project, rigid transform, pinhole project.  The 2x6
    coordinate-to-[rot, trs] Jacobian is ``[J_proj @ (-skew(R p0)) |
    J_proj]`` with ``J_proj = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]``;
    its rotation half, ``d @ -skew(a)``, is the cross product ``a x d``.
    The op order is the JAX function's: the in-view and depth-validity
    tests downstream compare these values exactly.

    :return: ``(u, v, dpt1, depth_valid, u6, v6)``, the first four
        ``[B,1,H,W]``, the transformed depth ``dpt1`` unclipped; ``u6/v6
        [B,HW,6]``
    """
    R, t = pose
    B, _, H, W_ = dpt0.shape
    hw = H * W_
    fx, fy, cx, cy = K[:, 0:1], K[:, 1:2], K[:, 2:3], K[:, 3:4]
    u_pix = torch.arange(W_, dtype=dpt0.dtype, device=dpt0.device).expand(B, H, W_)
    v_pix = torch.arange(H, dtype=dpt0.dtype, device=dpt0.device)[:, None].expand(B, H, W_)
    x_n = (u_pix.reshape(B, hw) - cx) / fx
    y_n = (v_pix.reshape(B, hw) - cy) / fy
    pnt0 = torch.stack([x_n, y_n, torch.ones_like(x_n)], dim=1) * dpt0.reshape(B, 1, hw)
    RP = R @ pnt0  # [B,3,HW] before the translation: the rotation Jacobian's
    pnt1 = RP + t[:, :, None]

    z = pnt1[:, 2]
    z_clip = torch.where((z >= 0) & (z < dpt_thr), dpt_thr, z)
    z_clip = torch.where((z_clip < 0) & (z_clip > -dpt_thr), -dpt_thr, z_clip)
    depth_valid = (z.abs() > dpt_thr).reshape(B, 1, H, W_)
    u = (pnt1[:, 0] / z_clip) * fx + cx
    v = (pnt1[:, 1] / z_clip) * fy + cy

    fx_z = fx / z_clip
    fy_z = fy / z_clip
    zero = torch.zeros_like(fx_z)
    du = torch.stack([fx_z, zero, -fx_z / z_clip * pnt1[:, 0]], dim=-1)  # [B,HW,3]
    dv = torch.stack([zero, fy_z, -fy_z / z_clip * pnt1[:, 1]], dim=-1)
    a = RP.transpose(1, 2)
    u6 = torch.cat([torch.linalg.cross(a, du, dim=-1), du], dim=-1)
    v6 = torch.cat([torch.linalg.cross(a, dv, dim=-1), dv], dim=-1)
    return (u.reshape(B, 1, H, W_), v.reshape(B, 1, H, W_), z.reshape(B, 1, H, W_),
            depth_valid, u6, v6)


def tr_ufc_level(pose, x0, x1, dpt0, dpt1, K, sigma0, sigma1, mest_fn, solver: DirectSolver,
                 w_prior=None, obj_mask0=None, obj_mask1=None, max_iter: int = 3,
                 train: bool = False, plain: bool = False, remat: bool = False):
    """One level of the forward-compositional uncertainty track (U_FC).

    The target's depth, features, sigma and the Sobel gradients of both
    are stacked into one operand before the loop; each iteration warps the
    depth map forward, samples the operand once at the warped pixels
    (interpolated target gradients), masks occluded and out-of-view pixels
    and those of invalid depth, and solves the system of the
    uncertainty-normalized residual, whose Jacobian coefficients are
    ``grad_f1/sigma - res * sigma_r * grad_sigma1/sigma^3`` (sign -1),
    weighted by ``mest_fn`` of the residual, damped by ``lev_mar_damp``,
    for a forward (``solver.direction``) update.  ``solver`` gives only
    the direction: a ``resvol`` solver's damping net is not applied, as in
    the JAX package.  Pixels outside the frame-0 object ``obj_mask0``, or
    whose warped frame-1 mask (the operand's last channel: C=29) is not >
    0, are invalid too.

    :param train: apply ``mest_fn`` first at the zero residual, as the JAX
        package does for its initial weights: in training a learned
        estimator's BatchNorm statistics then move ``1 + max_iter`` times a
        level, once for it and once an iteration.  In eval those weights
        are read only when ``max_iter`` is 0.
    :param plain: use the kernels' plain versions on any device
    :param remat: as in :func:`tr_uic_level`
    :return: ``(pose, weights, JtWJ)``: the last iteration's weights and
        system
    """
    B = x0.shape[0]
    gxf1, gyf1 = sobel_gradients(x1)
    gxs1, gys1 = sobel_gradients(sigma1)
    maps = [dpt1, x1, sigma1, gxf1, gyf1, gxs1, gys1]
    if obj_mask1 is not None:
        maps.append(obj_mask1.bool().to(x1.dtype))
    op, sizes = W.make_warp_operand(maps)

    weights = None
    if train or max_iter == 0:
        weights = mest_fn(torch.zeros_like(x0), x0, x1, w_prior)

    def iteration(_, carry):
        pose = carry[0]
        u, v, dpt_r, depth_valid, u6, v6 = _warp_forward_depth(dpt0, pose, K)
        warped = W.warp_operand(op, sizes, u, v, plain=plain)
        dpt1_w, f_r, sigma_r, a_f, b_f, a_s, b_s = warped[:7]
        occ = W.check_occ_prewarped(dpt_r, dpt1_w, u, v) | ~depth_valid
        if obj_mask0 is not None:
            occ = occ | ~obj_mask0.bool()
        if obj_mask1 is not None:
            occ = occ | ~(warped[7] > 0)
        res = f_r - x0
        sigma = torch.sqrt(sigma_r * sigma_r + sigma0 * sigma0)
        weighted_res = torch.where(occ, 1e-6, res / sigma)
        scale = res * sigma_r / (sigma * (sigma * sigma))
        alpha = torch.where(occ, 1e-6, a_f / sigma - scale * a_s)
        beta = torch.where(occ, 1e-6, b_f / sigma - scale * b_s)
        fac = FactoredJtJ(alpha=alpha, beta=beta, u=u6, v=v6, sign=-1.0)
        weights = mest_fn(weighted_res, x0, x1, w_prior)
        JtWJ, _ = jtj_jtr(fac, weighted_res, weights=weights)
        JtR = jtr_only(fac, weighted_res, weights=weights)
        return _update(solver, lev_mar_damp(JtWJ), JtR, pose), weights, JtWJ

    JtWJ = torch.zeros((B, 6, 6), dtype=x0.dtype, device=x0.device)
    return _iterate(iteration, (pose, weights, JtWJ), max_iter, remat)


def tr_ufc_residual(pose, x0, x1, dpt0, dpt1, K, sigma0, sigma1, obj_mask1=None,
                    plain: bool = False):
    """The U_FC track's average uncertainty-normalized residual at
    ``pose`` [B]: the target depth, features and sigma warp in one gather
    of their stacked operand (the JAX package warps them one by one, to
    the same values).  ``obj_mask1`` is taken and ignored, as in the JAX
    function: this residual masks no object."""
    u, v, dpt_r, depth_valid, _, _ = _warp_forward_depth(dpt0, pose, K)
    dpt1_w, f_r, sigma_r = W.warp_multi([dpt1, x1, sigma1], u, v, plain=plain)
    occ = W.check_occ_prewarped(dpt_r, dpt1_w, u, v) | ~depth_valid
    sigma = torch.sqrt(sigma_r * sigma_r + sigma0 * sigma0)
    weighted = ((f_r - x0) / sigma).masked_fill(occ, 1e-6)
    return compute_avg_loss([weighted], occ)


def tr_icp_level(pose, depth0, depth1, K, w_prior=None, obj_mask1=None, max_iter: int = 3,
                 direction: str = "inverse",
                 sigma_model: icp_mod.ICPSigmaModel = icp_mod.ICPSigmaModel(baseline=1.0),
                 plain: bool = False, remat: bool = False):
    """One level of the stand-alone point-to-plane ICP track, inverse- or
    forward-compositional.  ``obj_mask1`` is taken and ignored, as in the
    JAX function: the stand-alone ICP track masks no object.  ``remat`` as
    in :func:`tr_uic_level`.

    :return: ``(pose, weights, JtJ)``; the weights are ones
    """
    B, _, H, W_ = depth0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    vertex0 = W.compute_vertex(depth0, px, py)
    vertex1 = W.compute_vertex(depth1, px, py)
    normal1 = compute_normal(vertex1)
    icp_op = icp_mod.icp_operand(vertex1, normal1)
    residual_fn, update = {
        "inverse": (icp_mod.icp_residuals_inverse, inverse_update_pose),
        "forward": (icp_mod.icp_residuals_forward, forward_update_pose),
    }[direction]
    def iteration(_, carry):
        pose = carry[0]
        res, J, _ = residual_fn(vertex0, vertex1, normal1, pose, K, sigma_model=sigma_model,
                                warp_op=icp_op, plain=plain)
        JtJ, JtR = icp_mod.icp_jtj_jtr(J, res)
        return update(lev_mar_damp(JtJ), JtR, pose), JtJ

    JtJ = torch.zeros((B, 6, 6), dtype=depth0.dtype, device=depth0.device)
    pose, JtJ = _iterate(iteration, (pose, JtJ), max_iter, remat)
    return pose, torch.ones_like(depth0), JtJ


def tr_icp_point_level(pose, depth0, depth1, K, max_iter: int = 10, dist_thr: float = 0.05,
                       plain: bool = False, remat: bool = False):
    """One level of forward-compositional point-to-point ICP with
    projective association; ``remat`` as in :func:`tr_uic_level`.

    :return: ``(pose, JtJ)``
    """
    B, _, H, W_ = depth0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    vertex0 = W.compute_vertex(depth0, px, py)
    vertex1 = W.compute_vertex(depth1, px, py)
    def iteration(_, carry):
        pose = carry[0]
        res, J, _ = icp_mod.icp_residuals_point2point(vertex0, vertex1, pose, K,
                                                      dist_thr=dist_thr, plain=plain)
        JtJ, JtR = icp_mod.icp_p2p_jtj_jtr(J, res)
        return forward_update_pose(lev_mar_damp(JtJ), JtR, pose), JtJ

    JtJ = torch.zeros((B, 6, 6), dtype=depth0.dtype, device=depth0.device)
    return _iterate(iteration, (pose, JtJ), max_iter, remat)


def tr_icp_residual(pose, depth0, depth1, K, obj_mask1=None, plain: bool = False):
    """The ICP track's average inverse point-to-plane residual at ``pose``
    [B], with the ICP preset's sigma model (baseline 1.0); ``obj_mask1``
    is taken and ignored, as in the JAX function."""
    B, _, H, W_ = depth0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    vertex0 = W.compute_vertex(depth0, px, py)
    vertex1 = W.compute_vertex(depth1, px, py)
    res, _, occ = icp_mod.icp_residuals_inverse(vertex0, vertex1, compute_normal(vertex1), pose,
                                                K, sigma_model=icp_mod.ICPSigmaModel(baseline=1.0),
                                                plain=plain)
    return compute_avg_loss([res], occ)
