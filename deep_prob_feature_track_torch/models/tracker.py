"""LeastSquareTracking: encoder + coarse-to-fine U_IC trust-region solve.

Counterpart of ``deep_prob_feature_track_tpu/models/tracker.py`` for the
eval and training forwards of the ``feature`` preset (ConvRGBD2 encoder,
laplacian sigma, U_IC, SFMPoseNet initial pose).  Every other encoder,
track and head raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..geometry import warp as W
from ..ops.image import image_pyramid
from ..solvers.trust_region import tr_uic_level
from .encoder import FeaturePyramid
from .layers import color_normalize_nchw, seeded_init_
from .nets import ScaleNet, SFMPoseNet


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Typed configuration; defaults are the paper configuration."""

    encoder_name: str = "ConvRGBD2"  # RGB | ConvRGBD | ConvRGBD2 | ICP
    uncertainty_type: str = "laplacian"
    direction: str = "inverse"  # inverse | forward
    max_iter_per_pyr: int = 3
    mest_type: str = "None"  # None | MultiScale2w
    solver_type: str = "Direct-Nodamping"  # Direct-Nodamping | Direct-ResVol
    tr_samples: int = 10
    feature_channel: int = 8
    uncertainty_channel: int = 1
    feature_extract: str = "conv"  # 1by1 | conv | skip | average | prob_fuse
    combine_icp: bool = False
    scaler: str = "None"
    scale_scaler: Optional[float] = None
    remove_tru_sigma: bool = True
    init_pose_type: str = "sfm_net"  # identity | sfm_net | dense_net
    train_init_pose: bool = True
    scale_init_pose: float = 0.01
    multi_hypo: str = "prob_fuse"  # None | average | prob_fuse
    res_input: bool = False
    uncer_prop: bool = False
    no_weight_sharing: bool = False
    scale_icp: float = 0.01

    @property
    def track_type(self) -> str:
        if self.uncertainty_type == "ICP":
            return "ICP"
        if self.uncertainty_type == "None" and self.direction == "inverse":
            return "IC"
        if self.uncertainty_type != "None" and self.direction == "forward":
            return "U_FC"
        if self.uncertainty_type != "None" and self.direction == "inverse":
            return "U_IC"
        raise ValueError("unsupported (uncertainty, direction) combination")


def _check_ported(cfg: TrackerConfig) -> None:
    ported = {
        "encoder_name": "ConvRGBD2", "track_type": "U_IC", "mest_type": "None",
        "solver_type": "Direct-Nodamping", "combine_icp": False,
        "init_pose_type": "sfm_net", "uncer_prop": False, "no_weight_sharing": False,
    }
    for key, value in ported.items():
        if getattr(cfg, key) != value:
            raise NotImplementedError(
                f"TrackerConfig.{key}={getattr(cfg, key)!r} is not ported "
                f"(only the 'feature' preset's {key}={value!r})")


class LeastSquareTracking(nn.Module):
    """Deep probabilistic feature-metric tracker.

    In eval mode (the default) ``forward(img0, img1, depth0, depth1, K)``
    returns the final pose ``(R [B,3,3], t [B,3])``.  After ``.train()`` it
    returns the pose pyramid ``(pyr_R [B,5,3,3], pyr_t [B,5,3])``: the
    initial pose (with ``train_init_pose``), then the pose after each level
    3 -> 0.

    :param plain_kernels: run the plain PyTorch versions of the CUDA
        kernels, on any device (for comparison on the card)
    """

    def __init__(self, cfg: TrackerConfig = TrackerConfig(), plain_kernels: bool = False):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.plain_kernels = plain_kernels
        self.encoder = FeaturePyramid(
            in_channels=8,
            feature_channel=cfg.feature_channel,
            uncertainty_channel=cfg.uncertainty_channel,
            feature_extract=cfg.feature_extract,
            uncertainty_type=cfg.uncertainty_type,
        )
        self.scaler_func = ScaleNet(
            cfg.scaler, scale=cfg.scale_scaler if cfg.scale_scaler is not None else 0.01)
        self.pose_predictor = SFMPoseNet(
            in_channels=2 * 128,
            scale_motion=cfg.scale_init_pose,
            multi_hypo=cfg.multi_hypo,
            res_input=cfg.res_input,
        )
        self.eval()  # eval by default; .train() selects the training forward

    def reset_parameters(self, seed: int = 0) -> "LeastSquareTracking":
        """Seeded init of every weight, drawn on the CPU so that the same
        seed gives the same weights on every device."""
        g = torch.Generator().manual_seed(seed)
        device = next(self.parameters()).device
        self.to("cpu")
        seeded_init_(self, g)
        return self.to(device)

    def _slim_sigma(self, sigmas):
        """Keep one channel of a broadcast 1-channel laplacian sigma: the
        copies are identical and bilinear warping is per-channel linear, so
        the warp operand shrinks from C=17 to C=10 with identical values."""
        if self.cfg.uncertainty_channel != 1:
            return sigmas
        return [s[:, :1] for s in sigmas]

    def _preprocess(self, img0, img1, depth0, depth1):
        invD0 = torch.clamp(1.0 / depth0, 0.0, 10.0)
        invD1 = torch.clamp(1.0 / depth1, 0.0, 10.0)
        # zero out truncated inverse depths (batch-global min/max)
        invD0 = invD0.masked_fill((invD0 == invD0.amin()) | (invD0 == invD0.amax()), 0.0)
        invD1 = invD1.masked_fill((invD1 == invD1.amin()) | (invD1 == invD1.amax()), 0.0)
        I0 = color_normalize_nchw(img0)
        I1 = color_normalize_nchw(img1)

        m0 = torch.cat([I0, invD0, I1, invD1], dim=1)
        m1 = torch.cat([I1, invD1, I0, invD0], dim=1)
        if self.training:
            # two encoder passes: each normalizes with its own batch
            # statistics and the running statistics chain through both
            x0, sigma0, raw0 = self.encoder(m0)
            x1, sigma1, raw1 = self.encoder(m1)
        else:
            # both view orders in ONE stacked encoder pass (eval BatchNorm
            # makes the two halves independent)
            B = img0.shape[0]
            f_all, s_all, raw_all = self.encoder(torch.cat([m0, m1], dim=0))
            x0, x1 = [f[:B] for f in f_all], [f[B:] for f in f_all]
            sigma0, sigma1 = [s[:B] for s in s_all], [s[B:] for s in s_all]
            raw0, raw1 = [r[:B] for r in raw_all], [r[B:] for r in raw_all]
        inv_d0 = image_pyramid(invD0, pool="max")
        inv_d1 = image_pyramid(invD1, pool="max")
        pose = self.pose_predictor(raw0[3], raw1[3])
        return (x0, x1, self._slim_sigma(sigma0), self._slim_sigma(sigma1), inv_d0, inv_d1,
                pose)

    def forward(self, img0, img1, depth0, depth1, K):
        """:param img0/img1: [B,3,H,W] RGB in [0,1]
        :param depth0/depth1: [B,1,H,W] metric depth
        :param K: [B,4] intrinsics [fx,fy,cx,cy]
        :return: eval: final pose (R, t); training: (pyr_R, pyr_t)
        """
        x0, x1, sigma0, sigma1, inv_d0, inv_d1, pose = self._preprocess(
            img0, img1, depth0, depth1)
        poses = [pose] if self.cfg.train_init_pose else []
        for level in (3, 2, 1, 0):
            pose, _ = tr_uic_level(
                pose, x0[level], x1[level], inv_d0[level], inv_d1[level],
                W.scale_K(K, level), sigma0[level], sigma1[level],
                max_iter=self.cfg.max_iter_per_pyr,
                remove_tru_sigma=self.cfg.remove_tru_sigma,
                plain=self.plain_kernels,
            )
            poses.append(pose)
        if self.training:
            return torch.stack([R for R, _ in poses], 1), torch.stack([t for _, t in poses], 1)
        return pose
