"""Pose initializer, ICP scale, M-estimator and damping regressor of the
ported presets.

Counterpart of ``SFMPoseNet``, ``ScaleNet``, ``DeepRobustEstimator`` and
``DampingRegressor`` in ``deep_prob_feature_track_tpu/models/nets.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.lie import pose_vec_to_Rt
from ..ops.image import bilinear_resize_align
from .layers import Conv1dBlock, ConvBlock, FcRelu


class ScaleNet(nn.Module):
    """ICP<->feature scale balancer; only ``estimator_type="None"``, a
    constant ``scale``, is ported."""

    def __init__(self, estimator_type: str = "None", scale: float = 0.01):
        super().__init__()
        if estimator_type != "None":
            raise NotImplementedError(
                f"ScaleNet({estimator_type!r}) is not ported (ROADMAP item 3)")
        self.scale = scale

    def forward(self, residual, another_residual=None, w_prior=None):
        return torch.ones_like(residual) * self.scale


class DeepRobustEstimator(nn.Module):
    """M-estimator weights of the IC track.

    ``"None"``: constant ones.  ``"Huber"``: ``min(1, alpha/|r|)`` with
    alpha 0.02, with the gradient stopped at the residual.
    ``"MultiScale2w"``: ``[|r|, x0, x1, w_prior]`` (the prior weights
    upsampled to the level by :func:`bilinear_resize_align`) -> four conv
    blocks (16, 32, 64, 1 channels; dilations 1, 2, 4, 1) -> sigmoid; the
    blocks are ``net.{i}`` as in the reference.

    :param feature_channel: channels C of the residual and the features;
        the learned net takes 3C + 1
    """

    huber_alpha = 0.02

    def __init__(self, estimator_type: str = "None", feature_channel: int = 1):
        super().__init__()
        if estimator_type not in ("None", "Huber", "MultiScale2w"):
            raise NotImplementedError(f"DeepRobustEstimator({estimator_type!r}) is not ported")
        self.estimator_type = estimator_type
        if estimator_type == "MultiScale2w":
            self.net = nn.Sequential(
                ConvBlock(3 * feature_channel + 1, 16, 3),
                ConvBlock(16, 32, 3, dilation=2),
                ConvBlock(32, 64, 3, dilation=4),
                ConvBlock(64, 1, 3),
            )

    def forward(self, residual, x0=None, x1=None, w_prior=None, plain: bool = False):
        """:param plain: upsample through the kernels' plain versions"""
        if self.estimator_type == "None":
            return torch.ones_like(residual)
        if self.estimator_type == "Huber":
            a = self.huber_alpha
            abs_r = residual.detach().abs()
            return torch.where(abs_r > a, a / abs_r.clamp_min(a), 1.0)
        H, W = residual.shape[-2:]
        wl = bilinear_resize_align(w_prior, H, W, plain=plain)
        return torch.sigmoid(self.net(torch.cat([residual.abs(), x0, x1, wl], dim=1)))


class DampingRegressor(nn.Module):
    """Per-axis damping of the ``Direct-ResVol`` solve: three ``FcRelu``
    (``net.{i}``), ``in_features`` -> 128 -> 256 -> 6; the last ReLU keeps
    the damping non-negative."""

    def __init__(self, in_features: int):
        super().__init__()
        self.net = nn.Sequential(FcRelu(in_features, 128), FcRelu(128, 256), FcRelu(256, 6))

    def forward(self, x):
        return self.net(x)


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
                f"SFMPoseNet(multi_hypo={multi_hypo!r}, res_input={res_input}) is not ported "
                "(ROADMAP item 3)")
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
