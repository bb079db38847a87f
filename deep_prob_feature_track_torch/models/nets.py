"""Pose initializer, ICP scale and M-estimator of the ported presets.

Counterpart of ``SFMPoseNet``, ``ScaleNet`` and ``DeepRobustEstimator`` in
``deep_prob_feature_track_tpu/models/nets.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.lie import pose_vec_to_Rt
from .layers import Conv1dBlock, ConvBlock


class ScaleNet(nn.Module):
    """ICP<->feature scale balancer; only ``estimator_type="None"``, a
    constant ``scale``, is ported."""

    def __init__(self, estimator_type: str = "None", scale: float = 0.01):
        super().__init__()
        if estimator_type != "None":
            raise NotImplementedError(f"ScaleNet({estimator_type!r}) is not ported")
        self.scale = scale

    def forward(self, residual, another_residual=None, w_prior=None):
        return torch.ones_like(residual) * self.scale


class DeepRobustEstimator(nn.Module):
    """M-estimator weights of the IC track; only ``estimator_type="None"``,
    constant ones, is ported."""

    def __init__(self, estimator_type: str = "None"):
        super().__init__()
        if estimator_type != "None":
            raise NotImplementedError(f"DeepRobustEstimator({estimator_type!r}) is not ported")

    def forward(self, residual, x0=None, x1=None, w_prior=None):
        return torch.ones_like(residual)


class SFMPoseNet(nn.Module):
    """Pose initializer: level-3 raw features of both frames -> 2 dilated
    convs -> 1D head of 16 hypotheses fused by a confidence softmax
    (``multi_hypo="prob_fuse"``), scaled by ``scale_motion``, decoded by
    ``pose_vec_to_Rt``.  Names follow the reference: ``net``, ``final_layer``.
    """

    hypo_num = 16

    def __init__(self, in_channels: int = 256, scale_motion: float = 0.01,
                 multi_hypo: str = "prob_fuse", res_input: bool = False):
        super().__init__()
        if multi_hypo != "prob_fuse" or res_input:
            raise NotImplementedError(
                f"SFMPoseNet(multi_hypo={multi_hypo!r}, res_input={res_input}) is not ported")
        self.scale_motion = scale_motion
        self.net = nn.Sequential(
            ConvBlock(in_channels, 256, 3, dilation=2),
            ConvBlock(256, 256, 3, dilation=2),
        )
        self.final_layer = nn.Sequential(
            Conv1dBlock(256, 128, 1), nn.Conv1d(128, self.hypo_num * 7, 1))

    def forward(self, x0, x1):
        y = self.net(torch.cat([x0, x1], dim=1))
        B, C = y.shape[:2]
        seq = self.final_layer(y.reshape(B, C, -1))  # [B, 7*hypo, HW]
        pose = seq.mean(dim=2).reshape(B, self.hypo_num, 7)
        poses, conf = pose[..., :6], torch.softmax(pose[..., 6:], dim=1)
        pose = self.scale_motion * torch.sum(poses * conf, dim=1)
        return pose_vec_to_Rt(pose, rotation_mode="euler")
