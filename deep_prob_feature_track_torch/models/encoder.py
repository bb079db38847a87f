"""Feature/uncertainty pyramid encoder.

Counterpart of ``deep_prob_feature_track_tpu/models/encoder.py``: 4 stages
of 3 conv blocks (channels 32/64/96/128) with a 2x2 average pool between
stages, then per level a feature head and a sigma head.

Feature heads (``feature_extract``): ``conv`` (a conv block),
``1by1`` (a plain 1x1 conv with bias, xavier-uniform init), ``average``
(the channel mean of the level's raw features), ``skip`` (the raw features
themselves) and ``prob_fuse`` (a 16-channel conv block split into 8
features and 8 sigmoid gates, summed to one channel).

Sigma heads (``uncertainty_type``): ``laplacian``, ``gaussian``,
``sigmoid``, ``old_gaussian`` and ``old_laplacian`` (a conv block of 16 and
a conv of ``uncertainty_channel`` outputs, each with its activation and
clip; a 1-channel sigma is repeated to every feature channel),
``identity`` (ones like the features), ``feature`` (a conv block of
``feature_channel`` outputs, used as it is, not broadcast) and ``None`` (no
sigma).  Module names follow the reference ``state_dict``: ``net{i}``,
``f_conv{i}`` and ``sigma_conv{i}``; the heads without weights have no
modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBlock, XavierConv2d

STAGE_CHANNELS = (32, 64, 96, 128)
FEATURE_HEADS = ("conv", "1by1", "average", "skip", "prob_fuse")
# sigma activations of the conv-block-and-conv head, each on its clipped
# input; a 1-channel result is repeated to every feature channel
_SIGMA_ACTIVATIONS = {
    "gaussian": lambda s: torch.exp(0.5 * torch.clamp(s, -6.0, 6.0)),
    "laplacian": lambda s: torch.exp(torch.clamp(s, -3.0, 3.0)),
    "sigmoid": torch.sigmoid,
    "old_gaussian": lambda s: torch.exp(0.5 * torch.clamp(s, 1e-3, 1e3)),
    "old_laplacian": lambda s: torch.exp(torch.clamp(s, 1e-3, 1e3)),
}
SIGMA_TYPES = (*_SIGMA_ACTIVATIONS, "identity", "feature", "None")
PROB_FUSE_CHANNELS = 16  # 8 features + 8 gates


def _stage(in_c: int, mid: int, out: int) -> nn.Sequential:
    """conv(k3) -> conv(k3, d2) -> conv(k3, d2)."""
    return nn.Sequential(
        ConvBlock(in_c, mid, 3),
        ConvBlock(mid, out, 3, dilation=2),
        ConvBlock(out, out, 3, dilation=2),
    )


class FeaturePyramid(nn.Module):
    """4-level feature + uncertainty pyramid.

    ``forward(x [B,D,H,W])`` returns ``(features[4], sigmas[4], raw[4])``,
    NCHW lists, fine to coarse; each sigma is None without a sigma head.
    """

    def __init__(self, in_channels: int = 8, feature_channel: int = 8,
                 uncertainty_channel: int = 1, feature_extract: str = "conv",
                 uncertainty_type: str = "laplacian"):
        super().__init__()
        if feature_extract not in FEATURE_HEADS:
            raise ValueError(f"unknown feature_extract {feature_extract!r}")
        if uncertainty_type not in SIGMA_TYPES:
            raise ValueError(f"unknown uncertainty_type {uncertainty_type!r}")
        if uncertainty_channel not in (1, feature_channel):
            raise ValueError("uncertainty_channel must be 1 or feature_channel")
        self.feature_extract = feature_extract
        self.uncertainty_type = uncertainty_type
        self.uncertainty_channel = uncertainty_channel
        c0, c1, c2, c3 = STAGE_CHANNELS
        self.net0 = _stage(in_channels, 16, c0)
        self.net1 = _stage(c0, c0, c1)
        self.net2 = _stage(c1, c1, c2)
        self.net3 = _stage(c2, c2, c3)
        for i, c in enumerate(STAGE_CHANNELS):
            if feature_extract == "conv":
                setattr(self, f"f_conv{i}", ConvBlock(c, feature_channel, 1))
            elif feature_extract == "prob_fuse":
                setattr(self, f"f_conv{i}", ConvBlock(c, PROB_FUSE_CHANNELS, 1))
            elif feature_extract == "1by1":
                setattr(self, f"f_conv{i}", XavierConv2d(c, feature_channel, 1))
            if uncertainty_type in _SIGMA_ACTIVATIONS:
                setattr(self, f"sigma_conv{i}", nn.Sequential(
                    ConvBlock(c, 16, 1), nn.Conv2d(16, uncertainty_channel, 1)))
            elif uncertainty_type == "feature":
                setattr(self, f"sigma_conv{i}", ConvBlock(c, feature_channel, 1))

    def forward(self, x: torch.Tensor):
        x0 = self.net0(x)
        x1 = self.net1(F.avg_pool2d(x0, 2))
        x2 = self.net2(F.avg_pool2d(x1, 2))
        x3 = self.net3(F.avg_pool2d(x2, 2))
        raw = [x0, x1, x2, x3]
        feats = [self._feature(i, xi) for i, xi in enumerate(raw)]
        sigmas = [self._sigma(i, xi, f) for i, (xi, f) in enumerate(zip(raw, feats))]
        return feats, sigmas, raw

    def _feature(self, i: int, x: torch.Tensor) -> torch.Tensor:
        fe = self.feature_extract
        if fe == "skip":
            return x
        if fe == "average":
            return x.mean(dim=1, keepdim=True)
        y = getattr(self, f"f_conv{i}")(x)
        if fe == "prob_fuse":
            f, p = y.chunk(2, dim=1)
            return torch.sum(f * torch.sigmoid(p), dim=1, keepdim=True)
        return y

    def _sigma(self, i: int, x: torch.Tensor, f: torch.Tensor):
        ut = self.uncertainty_type
        if ut == "None":
            return None
        if ut == "identity":
            return torch.ones_like(f)
        s = getattr(self, f"sigma_conv{i}")(x)
        if ut == "feature":
            return s
        s = _SIGMA_ACTIVATIONS[ut](s)
        if self.uncertainty_channel == 1 and f.shape[1] != 1:
            # broadcast the 1-channel sigma to every feature channel
            s = s.expand(-1, f.shape[1], -1, -1)
        return s
