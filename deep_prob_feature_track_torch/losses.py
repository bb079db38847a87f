"""Training and evaluation criteria: the 3D end-point error of the scene
flow a pose induces, and the relative pose error.

Counterpart of ``epe3d``, ``rpe``, ``compute_rpe_error``,
``compute_rpe_loss``, ``_downsampled_geometry`` and ``compute_rt_epe_loss``
in ``deep_prob_feature_track_tpu/losses.py``.  The uncertainty-propagating
losses (URPE, UEPE3D) are not ported (ROADMAP item 4):
``training/train.py::compute_loss`` raises for them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .geometry import warp as W
from .geometry.lie import between, rotation_angle
from .ops.image import bilinear_resize


def epe3d(flow_est: torch.Tensor, flow_gt: torch.Tensor,
          invalid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample masked mean of ``||flow_est - flow_gt||``.

    :param flow_est/flow_gt: [B,3,H,W]
    :param invalid: optional [B,1,H,W] (>0 means invalid)
    :return: [B]
    """
    epe_map = torch.linalg.vector_norm(flow_gt - flow_est, dim=1)  # [B,H,W]
    mask = torch.isnan(flow_gt).any(dim=1)
    if invalid is not None:
        mask = mask | (invalid[:, 0] > 0)
    valid = ~mask
    num = torch.where(valid, epe_map, 0.0).sum(dim=(1, 2))
    den = valid.sum(dim=(1, 2))
    return torch.where(den > 0, num / den.clamp(min=1), 0.0)


def rpe(R: torch.Tensor, t: torch.Tensor):
    """Relative pose error: (angle [rad], translation norm)."""
    return rotation_angle(R), torch.linalg.vector_norm(t, dim=-1)


def compute_rpe_error(R_est, t_est, R_gt, t_gt):
    """RPE of the estimated against the true pose, per sample."""
    return rpe(*between(R_est, t_est, R_gt, t_gt))


def compute_rpe_loss(R_est_pyr, t_est_pyr, R_gt, t_gt):
    """Training RPE loss of a pose pyramid ``[B,L,...]``: over the L poses,
    the sum of the norms (over the batch) of the angle and translation
    errors."""
    angs, trss = zip(*(compute_rpe_error(R_est_pyr[:, i], t_est_pyr[:, i], R_gt, t_gt)
                       for i in range(R_est_pyr.shape[1])))
    return (sum(torch.linalg.vector_norm(a) for a in angs),
            sum(torch.linalg.vector_norm(t) for t in trss))


def _downsampled_geometry(depth0, K, invalid, rH: int = 60, rW: int = 80):
    """Training-time 60x80 point cloud with rescaled K, and the resized
    invalid mask (> 0 wherever a resized pixel touches an invalid one)."""
    _, _, H, W_ = depth0.shape
    rdepth = bilinear_resize(depth0, rH, rW)
    rinvalid = None
    if invalid is not None:
        rinvalid = bilinear_resize(invalid.to(depth0.dtype), rH, rW)
    rK = W.resize_K(K, float(rW) / W_, float(rH) / H)
    return W.batch_inverse_project(rdepth, rK), rinvalid


def compute_rt_epe_loss(R_est, t_est, R_gt, t_gt, depth0, K, invalid=None) -> torch.Tensor:
    """EPE3D of the scene flow induced by the estimated vs the true pose.

    Training mode (``R_est`` [B,L,3,3], a pose pyramid): the sum over the L
    poses of EPE3D on the 60x80 downsampled geometry, with the true flow
    detached.  Eval mode (``R_est`` [B,3,3]): one pose at full resolution.

    :return: [B]
    """
    if R_est.ndim > 3:
        xyz, rinvalid = _downsampled_geometry(depth0, K, invalid)
        flow_gt = W.batch_transform_xyz(xyz, R_gt, t_gt).detach()
        return sum(epe3d(W.batch_transform_xyz(xyz, R_est[:, i], t_est[:, i]), flow_gt,
                         invalid=rinvalid)
                   for i in range(R_est.shape[1]))
    xyz = W.batch_inverse_project(depth0, K)
    flow_gt = W.batch_transform_xyz(xyz, R_gt, t_gt)
    flow_est = W.batch_transform_xyz(xyz, R_est, t_est)
    return epe3d(flow_est, flow_gt, invalid=invalid)
