"""Training and evaluation criteria: the 3D end-point error of the scene
flow a pose induces, the relative pose error, and their
uncertainty-propagating forms.

Counterpart of ``epe3d``, ``rpe``, ``compute_rpe_error``,
``compute_rpe_loss``, ``_downsampled_geometry``, ``compute_rt_epe_loss``,
``compute_rpe_uncertainty_loss`` (URPE), ``uepe3d`` and
``compute_rt_epe_uncertainty_loss`` (UEPE3D) in
``deep_prob_feature_track_tpu/losses.py``.  The 3x3 and 6x6 inverses and
determinants are ``torch.linalg``'s, as the JAX functions take
``jnp.linalg``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from .geometry import warp as W
from .geometry.lie import between, log_so3, rotation_angle
from .ops.image import bilinear_resize
from .ops.solver6 import lev_mar_damp
from .parallel import mesh as M


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
    return sum(_norm_over_batch(a) for a in angs), sum(_norm_over_batch(t) for t in trss)


def _norm_over_batch(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of ``x`` over the batch: the global batch's while a mesh
    is active (``parallel/mesh.py``)."""
    mesh = M.current()
    if mesh is None or mesh.world == 1:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(M.all_reduce_sum((x * x).sum(), mesh))


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


def compute_rpe_uncertainty_loss(R_est_pyr, t_est_pyr, R_gt, t_gt, inv_var_pyr) -> torch.Tensor:
    """URPE: over the L poses of the pyramid, the sum over the batch of the
    Mahalanobis norm of the twist error ``[log R_gt - log R, t_gt - t]``
    under each level's information matrix ``inv_var_pyr`` [B,L,6,6], plus
    ``log(1e-6 + det)`` of the covariance ``lev_mar_damp(inv_var)^-1``, its
    determinant clamped at 1e-9 from below.  The true pose is detached.

    :return: a scalar
    """
    w_gt = log_so3(R_gt).detach()
    t_gt = t_gt.detach()
    total = 0.0
    for i in range(R_est_pyr.shape[1]):
        dksi = torch.cat([w_gt - log_so3(R_est_pyr[:, i]), t_gt - t_est_pyr[:, i]], dim=-1)
        inv_var = inv_var_pyr[:, i]
        det = torch.linalg.det(torch.linalg.inv(lev_mar_damp(inv_var))).clamp(min=1e-9)
        weighted = torch.einsum("bi,bij,bj->b", dksi, inv_var, dksi)
        total = total + torch.sum(weighted + torch.log(1e-6 + det))
    return total


def _masked_mean(m, valid):
    num = torch.where(valid, m, 0.0).sum(dim=(1, 2))
    den = valid.sum(dim=(1, 2))
    return torch.where(den > 0, num / den.clamp(min=1), 0.0)


def uepe3d(flow_est, flow_gt, variance, invalid=None):
    """Gaussian negative log-likelihood of the flow error under a per-pixel
    covariance, taken per axis: the diagonal of ``variance`` [B,HW,3,3],
    clamped at 1e-3 from below, gives the Mahalanobis term and the
    ``sum log`` regularizer.  Pixels with a NaN true flow or ``invalid``
    (> 0) are left out of the per-sample means.

    :return: ``(nll [B], epe [B])``
    """
    B, _, H, W_ = flow_est.shape
    deltaP = flow_gt - flow_est
    o_epe = torch.linalg.vector_norm(deltaP, dim=1)  # [B,H,W]
    d = deltaP.reshape(B, 3, -1).transpose(1, 2)  # [B,HW,3]
    var = variance.clamp(min=1e-3) * torch.eye(3, dtype=variance.dtype, device=variance.device)
    weighted = torch.einsum("bpi,bpij,bpj->bp", d, torch.linalg.inv(var), d)
    reg = torch.log(torch.diagonal(var, dim1=-2, dim2=-1)).sum(-1)
    nll_map = (weighted + reg).reshape(B, H, W_)
    mask = torch.isnan(flow_gt).any(dim=1)
    if invalid is not None:
        mask = mask | (invalid[:, 0] > 0)
    valid = ~mask
    return _masked_mean(nll_map, valid), _masked_mean(o_epe, valid)


def compute_rt_epe_uncertainty_loss(R_est_pyr, t_est_pyr, R_gt, t_gt, depth0, K, sigma_ksi_pyr,
                                    invalid=None):
    """UEPE3D: over the L poses of the pyramid, :func:`uepe3d` of the scene
    flow on the 60x80 downsampled geometry, the 6x6 pose covariance
    ``sigma_ksi_pyr`` [B,L,6,6] pushed through the flow Jacobian
    ``J Sigma J'`` per pixel; the true flow detached.

    :return: ``(nll [B], epe [B])``, each summed over the levels
    """
    xyz, rinvalid = _downsampled_geometry(depth0, K, invalid)
    flow_gt = W.batch_transform_xyz(xyz, R_gt, t_gt).detach()
    nll = epe = 0.0
    for i in range(R_est_pyr.shape[1]):
        Ri = R_est_pyr[:, i]
        J = W.transform_xyz_jacobian(xyz, Ri)  # [B,HW,3,6]
        var = torch.einsum("bpij,bjk,bplk->bpil", J, sigma_ksi_pyr[:, i], J)
        n, e = uepe3d(W.batch_transform_xyz(xyz, Ri, t_est_pyr[:, i]), flow_gt, var,
                      invalid=rinvalid)
        nll, epe = nll + n, epe + e
    return nll, epe
