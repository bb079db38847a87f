"""Feature/uncertainty pyramid encoder.

Counterpart of ``deep_prob_feature_track_tpu/models/encoder.py`` for the
feature heads ``conv`` (a conv block per level) and ``average`` (the channel
mean of each level's raw features, no weights) and the sigma heads
``laplacian`` (a conv block and a conv per level) and ``None`` (no sigma):
4 stages of 3 conv blocks (channels 32/64/96/128) with a 2x2 average pool
between stages.  Module names follow the reference ``state_dict``:
``net{i}``, ``f_conv{i}`` and ``sigma_conv{i}``; the ``average`` and
``None`` heads have no modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBlock

STAGE_CHANNELS = (32, 64, 96, 128)


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
        if feature_extract not in ("conv", "average"):
            raise NotImplementedError(f"feature_extract={feature_extract!r} is not ported")
        if uncertainty_type not in ("laplacian", "None"):
            raise NotImplementedError(f"uncertainty_type={uncertainty_type!r} is not ported")
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
            if uncertainty_type == "laplacian":
                setattr(self, f"sigma_conv{i}", nn.Sequential(
                    ConvBlock(c, 16, 1), nn.Conv2d(16, uncertainty_channel, 1)))

    def forward(self, x: torch.Tensor):
        x0 = self.net0(x)
        x1 = self.net1(F.avg_pool2d(x0, 2))
        x2 = self.net2(F.avg_pool2d(x1, 2))
        x3 = self.net3(F.avg_pool2d(x2, 2))
        raw = [x0, x1, x2, x3]
        feats, sigmas = [], []
        for i, xi in enumerate(raw):
            if self.feature_extract == "conv":
                f = getattr(self, f"f_conv{i}")(xi)
            else:
                f = xi.mean(dim=1, keepdim=True)
            s = None
            if self.uncertainty_type == "laplacian":
                s = torch.exp(torch.clamp(getattr(self, f"sigma_conv{i}")(xi), -3.0, 3.0))
                if self.uncertainty_channel == 1 and f.shape[1] != 1:
                    # broadcast the 1-channel sigma to every feature channel
                    s = s.expand(-1, f.shape[1], -1, -1)
            feats.append(f)
            sigmas.append(s)
        return feats, sigmas, raw
