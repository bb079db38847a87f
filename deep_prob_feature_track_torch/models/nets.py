"""The tracker's learned parts: the pose initializers, the ICP scale, the
M-estimator and the damping regressor.

Counterpart of ``SFMPoseNet``, ``PoseNetFeat``, ``PoseNet``, ``ScaleNet``,
``DeepRobustEstimator`` and ``DampingRegressor`` in
``deep_prob_feature_track_tpu/models/nets.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.lie import euler_to_matrix, pose_vec_to_Rt
from ..ops.image import bilinear_resize_align
from .layers import Conv1dBlock, ConvBlock, FcRelu


class ScaleNet(nn.Module):
    """ICP<->feature scale balancer.

    ``"None"``: the constant ``scale``.  The learned types read the
    per-pixel squared norms (``rtr``, summed over channels) of the ICP
    residual (``oneResidual``), of it and the feature residual
    (``twoResidual``), or of both and the prior weights upsampled to the
    level by :func:`bilinear_resize_align` (``MultiScale2w``,
    ``expMultiScale``): four conv blocks (16, 32, 64, 16 channels;
    dilations 1, 2, 4, 1) and a 1x1 conv (``net.{0-4}``, as in the
    reference), then a sigmoid, or ``exp(clip(w, -6, 6))`` for
    ``expMultiScale``, times ``scale``.
    """

    IN_CHANNELS = {"oneResidual": 1, "twoResidual": 2, "MultiScale2w": 3, "expMultiScale": 3}

    def __init__(self, estimator_type: str = "None", scale: float = 0.01):
        super().__init__()
        if estimator_type != "None" and estimator_type not in self.IN_CHANNELS:
            raise ValueError(f"unknown ScaleNet type {estimator_type!r}")
        self.estimator_type = estimator_type
        self.scale = scale
        if self.learned:
            self.net = nn.Sequential(
                ConvBlock(self.IN_CHANNELS[estimator_type], 16, 3),
                ConvBlock(16, 32, 3, dilation=2),
                ConvBlock(32, 64, 3, dilation=4),
                ConvBlock(64, 16, 3),
                nn.Conv2d(16, 1, 1),
            )

    @property
    def learned(self) -> bool:
        """Whether the scale reads the residuals (else it is constant)."""
        return self.estimator_type != "None"

    def forward(self, residual, another_residual=None, w_prior=None, plain: bool = False):
        """:param plain: upsample the prior weights through the kernels'
            plain versions"""
        if not self.learned:
            return torch.ones_like(residual) * self.scale

        def rtr(res):
            return torch.sum(res * res, dim=1, keepdim=True)

        inp = [rtr(residual)]
        if self.estimator_type != "oneResidual":
            inp.append(rtr(another_residual))
        if self.IN_CHANNELS[self.estimator_type] == 3:
            H, W = residual.shape[-2:]
            inp.append(bilinear_resize_align(w_prior, H, W, plain=plain))
        w = self.net(torch.cat(inp, dim=1))
        if self.estimator_type == "expMultiScale":
            return torch.exp(torch.clamp(w, -6.0, 6.0)) * self.scale
        return torch.sigmoid(w) * self.scale


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
            raise ValueError(f"unknown DeepRobustEstimator type {estimator_type!r}")
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
    """Pose initializer: level-3 raw features of both frames (with
    ``res_input``, their difference too) -> 2 dilated convs -> a pose
    vector scaled by ``scale_motion``, decoded by ``pose_vec_to_Rt``.

    ``multi_hypo``: ``"prob_fuse"`` (a 1D head of 16 hypotheses fused by a
    confidence softmax), ``"average"`` (16 hypotheses of 6, averaged) or
    ``"None"`` (a 1x1 conv to 6 channels, then the spatial mean).  Names
    follow the reference: ``net``, ``final_layer``.

    :param in_channels: channels of the input: twice the raw features'
        (three times with ``res_input``)
    """

    hypo_num = 16

    def __init__(self, in_channels: int = 256, scale_motion: float = 0.01,
                 multi_hypo: str = "prob_fuse", res_input: bool = False):
        super().__init__()
        if multi_hypo not in ("None", "average", "prob_fuse"):
            raise ValueError(f"unknown multi_hypo {multi_hypo!r}")
        self.scale_motion = scale_motion
        self.multi_hypo = multi_hypo
        self.res_input = res_input
        self.net = nn.Sequential(
            ConvBlock(in_channels, 256, 3, dilation=2),
            ConvBlock(256, 256, 3, dilation=2),
        )
        if multi_hypo == "None":
            self.final_layer = nn.Conv2d(256, 6, 1)
        else:
            per = 7 if multi_hypo == "prob_fuse" else 6
            self.final_layer = nn.Sequential(
                Conv1dBlock(256, 128, 1), nn.Conv1d(128, self.hypo_num * per, 1))

    def forward(self, x0, x1):
        inp = [x0, x1, x0 - x1] if self.res_input else [x0, x1]
        y = self.net(torch.cat(inp, dim=1))
        B, C = y.shape[:2]
        if self.multi_hypo == "None":
            pose = self.final_layer(y).mean(dim=(2, 3))
        else:
            pooled = self.final_layer(y.reshape(B, C, -1)).mean(dim=2)
            if self.multi_hypo == "average":
                pose = pooled.reshape(B, self.hypo_num, 6).mean(dim=1)
            else:
                pose = pooled.reshape(B, self.hypo_num, 7)
                poses, conf = pose[..., :6], torch.softmax(pose[..., 6:], dim=1)
                pose = torch.sum(poses * conf, dim=1)
        return pose_vec_to_Rt(self.scale_motion * pose, rotation_mode="euler")


class PoseNetFeat(nn.Module):
    """Dense per-pixel pose embedding of one frame's level-3 raw features:
    two stride-2 conv blocks of 128 (``net``), then 1D embeddings of 256,
    512 and ``final_c`` channels (``emb``) and the last one's mean over the
    pixels, broadcast back to them.

    :return: ``(emb1 [B,256,N], emb2 [B,512,N], mean [B,final_c,N])``
    """

    def __init__(self, in_channels: int, final_c: int = 1024):
        super().__init__()
        self.net = nn.Sequential(ConvBlock(in_channels, 128, 3, stride=2),
                                 ConvBlock(128, 128, 3, stride=2))
        self.emb = nn.ModuleList([Conv1dBlock(128, 256), Conv1dBlock(256, 512),
                                  Conv1dBlock(512, final_c)])

    def forward(self, x):
        y = self.net(x)
        e1 = self.emb[0](y.reshape(y.shape[0], y.shape[1], -1))
        e2 = self.emb[1](e1)
        final = self.emb[2](e2)
        return e1, e2, final.mean(dim=2, keepdim=True).expand_as(final)


class PoseNet(nn.Module):
    """The ``dense_net`` pose initializer: :class:`PoseNetFeat` shared by
    both frames, three 1D heads on the concatenated embeddings (3584 ->
    640 -> 256 -> 128 -> 3, 3 and 1 channels: rotation, translation and
    confidence), the confidence softmax over pixels pooling each, scaled by
    ``scale_motion``; the rotation decoded by ``euler_to_matrix``.

    Module names follow the flax tree: ``feat_net``; the heads' conv blocks
    ``blocks.{0-8}`` (three a head, rotation first) and their last convs
    ``convs.{0-2}``.
    """

    def __init__(self, in_channels: int, scale_motion: float = 0.01, final_c: int = 1024):
        super().__init__()
        self.scale_motion = scale_motion
        self.feat_net = PoseNetFeat(in_channels, final_c)
        width = 2 * (256 + 512 + final_c)
        self.blocks = nn.ModuleList()
        self.convs = nn.ModuleList()
        for out_c in (3, 3, 1):
            self.blocks.extend([Conv1dBlock(width, 640), Conv1dBlock(640, 256),
                                Conv1dBlock(256, 128)])
            self.convs.append(nn.Conv1d(128, out_c, 1))

    def forward(self, x0, x1):
        e1_0, e2_0, ap_0 = self.feat_net(x0)
        e1_1, e2_1, ap_1 = self.feat_net(x1)
        feat = torch.cat([e1_0, e1_1, e2_0, e2_1, ap_0, ap_1], dim=1)
        rot, trs, conf = (self.convs[h](self.blocks[3 * h + 2](self.blocks[3 * h + 1](
            self.blocks[3 * h](feat)))) for h in range(3))
        conf = torch.softmax(conf, dim=2)
        rot = self.scale_motion * torch.sum(rot * conf, dim=2)
        trs = self.scale_motion * torch.sum(trs * conf, dim=2)
        return euler_to_matrix(rot[:, 0], rot[:, 1], rot[:, 2]), trs
