"""Point-to-plane and point-to-point ICP residuals, their analytic
Jacobians and normal equations.

Counterpart of ``deep_prob_feature_track_tpu/solvers/icp.py``.  The
per-pixel Jacobian has one residual channel (point-to-plane) or three
(point-to-point), so it is materialized, ``[B,HW,6]`` or ``[B,HW,3,6]``, and
reduced with batched matmuls.  The target maps (vertices and normals of
frame 1) are warped in one gather of their stacked operand: kernel K1 (K4
where ``use_tiles`` holds) without autograd, K2 (K5) under it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import warp as W
from ..geometry.lie import skew


class ICPSigmaModel(NamedTuple):
    """Stereo depth-noise model constants."""

    sigma_disp: float = 0.4
    sigma_xy: float = 5.5
    baseline: float = 1.2  # 1.0 in the stand-alone ICP track
    focal: float = 525.0


def compute_icp_sigma(dpt0, r_normal1, R, model: ICPSigmaModel):
    """Per-pixel point-to-plane sigma ``[B,1,H,W]``: the per-axis depth
    sigmas ``[d/f*s_xy, d/f*s_xy, d^2*s_disp/(f*b)]`` pushed through
    ``n^T R``."""
    sxy = dpt0 / model.focal * model.sigma_xy
    sz = dpt0 * dpt0 * model.sigma_disp / (model.focal * model.baseline)
    sigma_depth = torch.cat([sxy, sxy, sz], dim=1)  # [B,3,H,W]
    J = torch.einsum("bchw,bcd->bdhw", r_normal1, R)
    cov = (J * sigma_depth * sigma_depth * J).sum(dim=1, keepdim=True)
    return torch.sqrt(cov + 1e-8)


def _project(vertex0, pose10, K):
    """Frame-0 vertices in frame 1 ``[B,3,HW]``, their pixel coordinates
    ``[B,1,H,W]`` each, and the strict in-view test ``0 < u < W-1``,
    ``0 < v < H-1`` ``[B,1,H,W]``."""
    R, t = pose10
    B, _, H, W_ = vertex0.shape
    v0_in_1 = R @ vertex0.reshape(B, 3, H * W_) + t[:, :, None]
    fx, fy, cx, cy = K[:, 0:1], K[:, 1:2], K[:, 2:3], K[:, 3:4]
    u_ = (v0_in_1[:, 0] / v0_in_1[:, 2]) * fx + cx
    v_ = (v0_in_1[:, 1] / v0_in_1[:, 2]) * fy + cy
    inviews = (u_ > 0) & (u_ < W_ - 1) & (v_ > 0) & (v_ < H - 1)
    shape = (B, 1, H, W_)
    return v0_in_1, u_.reshape(shape), v_.reshape(shape), inviews.reshape(shape)


def _point_to_plane(vertex0, vertex1, normal1, pose10, K, warp_op, plain, obj_mask0=None,
                    obj_mask1=None):
    """The shared half of both point-to-plane residuals: ``T v0`` in frame 1,
    the warped normals ``[B,3,HW]``, the difference ``T v0 - v1_r``
    ``[B,3,HW]``, the residual ``n_r . diff`` ``[B,1,H,W]`` and the invalid
    mask (out of view, or ``|diff| > 0.1``; outside the frame-0 object
    ``obj_mask0``, or where the warped frame-1 mask is not > 0).  The
    frame-1 mask rides in the operand as its third map: ``warp_op``, when
    given, must hold it exactly when ``obj_mask1`` is given."""
    B, _, H, W_ = vertex0.shape
    v0_in_1, u, v, inviews = _project(vertex0, pose10, K)
    if warp_op is None:
        warp_op = icp_operand(vertex1, normal1, obj_mask1)
    warped = W.warp_operand(*warp_op, u, v, plain=plain)
    r_vertex1, r_normal1 = warped[:2]
    diff = v0_in_1 - r_vertex1.reshape(B, 3, H * W_)
    n_r = r_normal1.reshape(B, 3, H * W_)
    occ = ~inviews | (torch.linalg.vector_norm(diff, dim=1).reshape(B, 1, H, W_) > 0.1)
    if obj_mask0 is not None:
        occ = occ | ~obj_mask0.bool()
    if obj_mask1 is not None:
        occ = occ | ~(warped[2] > 0)
    res = (n_r * diff).sum(dim=1).reshape(B, 1, H, W_)
    return v0_in_1, r_normal1, n_r, res, occ


def icp_operand(vertex1, normal1, obj_mask1=None):
    """The stacked operand ``[vertex1 | normal1]`` (C=6) that the ICP
    residuals warp, with the frame-1 object mask as a seventh channel where
    given; loop-invariant."""
    maps = [vertex1, normal1]
    if obj_mask1 is not None:
        maps.append(obj_mask1.bool().to(vertex1.dtype))
    return W.make_warp_operand(maps)


def _normalize(res, J, vertex0, r_normal1, R, sigma_model):
    """Sigma-normalize, flip the Jacobian's sign and mask the residual to
    1e-6 where invalid (the Jacobian stays unmasked)."""
    B = res.shape[0]
    sigma = compute_icp_sigma(vertex0[:, 2:3], r_normal1, R, sigma_model)
    res = res / (sigma + 1e-8)
    J = J / (sigma.reshape(B, -1, 1) + 1e-8)
    return res, -J


def icp_residuals_inverse(vertex0, vertex1, normal1, pose10, K, obj_mask0=None,
                          obj_mask1=None, sigma_model: ICPSigmaModel = ICPSigmaModel(),
                          normalize_residual: bool = True, warp_op=None, plain: bool = False):
    """Inverse point-to-plane residual ``n_r . (T v0 - v1_r)`` and its
    Jacobian ``[(n_r^T R) [v0]x | -(n_r^T R)]``, sigma-normalized and
    sign-flipped for the inverse composition.  Pixels outside the frame-0
    object ``obj_mask0``, or whose warped frame-1 mask ``obj_mask1`` is not
    > 0, are invalid.

    :param warp_op: the stacked operand of :func:`icp_operand` (with the
        frame-1 mask exactly when ``obj_mask1`` is given), to reuse across
        iterations; built from the maps when None
    :return: ``(res [B,1,H,W], J [B,HW,6], occ [B,1,H,W])``
    """
    R = pose10[0]
    B = vertex0.shape[0]
    _, r_normal1, n_r, res, occ = _point_to_plane(vertex0, vertex1, normal1, pose10, K,
                                                  warp_op, plain, obj_mask0, obj_mask1)
    NtC10 = torch.einsum("bcp,bcd->bpd", n_r, R)  # n_r^T R  [B,HW,3]
    v0_pix = vertex0.reshape(B, 3, -1).transpose(1, 2)
    # a^T [v]x == (a x v)^T
    J = torch.cat([torch.linalg.cross(NtC10, v0_pix, dim=-1), -NtC10], dim=-1)
    if normalize_residual:
        res, J = _normalize(res, J, vertex0, r_normal1, R, sigma_model)
    else:
        J = -J
    return res.masked_fill(occ, 1e-6), J, occ


def icp_residuals_forward(vertex0, vertex1, normal1, pose10, K,
                          sigma_model: ICPSigmaModel = ICPSigmaModel(baseline=1.0),
                          warp_op=None, plain: bool = False):
    """Forward-compositional point-to-plane residual and its Jacobian
    ``[-n_r^T [T v0]x | n_r]``, sigma-normalized and sign-flipped.

    :return: ``(res [B,1,H,W], J [B,HW,6], occ [B,1,H,W])``
    """
    R = pose10[0]
    v0_in_1, r_normal1, n_r, res, occ = _point_to_plane(vertex0, vertex1, normal1, pose10,
                                                        K, warp_op, plain)
    n_pix = n_r.transpose(1, 2)  # [B,HW,3]
    J = torch.cat([-torch.linalg.cross(n_pix, v0_in_1.transpose(1, 2), dim=-1), n_pix],
                  dim=-1)
    res, J = _normalize(res, J, vertex0, r_normal1, R, sigma_model)
    return res.masked_fill(occ, 1e-6), J, occ


def icp_residuals_point2point(vertex0, vertex1, pose10, K, dist_thr: float = 0.05,
                              plain: bool = False):
    """Point-to-point residual ``T v0 - v1_r`` by projective association,
    and the Jacobian of the right-composed update, ``-[-R [v0]x | R]``; both
    zero where invalid (out of view, or farther apart than ``dist_thr``).

    :return: ``(res [B,3,H,W], J [B,HW,3,6], occ [B,1,H,W])``
    """
    R = pose10[0]
    B, _, H, W_ = vertex0.shape
    hw = H * W_
    v0_in_1, u, v, inviews = _project(vertex0, pose10, K)
    r_vertex1 = W.warp_features(vertex1, u, v, plain=plain)
    diff = (v0_in_1 - r_vertex1.reshape(B, 3, hw)).reshape(B, 3, H, W_)
    occ = ~inviews | (torch.linalg.vector_norm(diff, dim=1, keepdim=True) > dist_thr)
    v0_pix = vertex0.reshape(B, 3, hw).transpose(1, 2)
    J_rot = torch.einsum("bcd,bpde->bpce", R, skew(v0_pix))  # R [v0]x
    J_trs = -R[:, None].expand(B, hw, 3, 3)
    J = torch.cat([J_rot, J_trs], dim=-1)
    return diff.masked_fill(occ, 0.0), J.masked_fill(occ.reshape(B, hw, 1, 1), 0.0), occ


def icp_jtj_jtr(J, res):
    """``(J^T J [B,6,6], J^T r [B,6,1])`` of a one-channel residual."""
    B = J.shape[0]
    Jt = J.transpose(1, 2)
    return Jt @ J, Jt @ res.reshape(B, -1, 1)


def icp_p2p_jtj_jtr(J, res):
    """``(JtJ [B,6,6], JtR [B,6,1])`` of the three-channel point-to-point
    residual ``[B,3,H,W]`` with ``J [B,HW,3,6]``."""
    B, hw = J.shape[:2]
    Jf = J.reshape(B, hw * 3, 6)
    r = res.reshape(B, 3, hw).transpose(1, 2).reshape(B, hw * 3, 1)
    Jt = Jf.transpose(1, 2)
    return Jt @ Jf, Jt @ r
