"""LeastSquareTracking: encoder + coarse-to-fine trust-region solve.

Counterpart of ``deep_prob_feature_track_tpu/models/tracker.py`` for the
eval and training forwards of the presets ``feature`` and ``feature_icp``
(ConvRGBD2 encoder, laplacian sigma, U_IC, SFMPoseNet initial pose, with
the fused ICP term in ``feature_icp``), ``DeepIC`` (ConvRGBD2 encoder with
the ``average`` head and no sigma, IC with the learned ``MultiScale2w``
M-estimator and the ``Direct-ResVol`` damping, from the identity pose) and
the classical presets ``RGB`` (grayscale IC), ``ICP`` (point-to-plane ICP)
and ``RGB+ICP`` (grayscale U_IC with the fused ICP term), which start from
the identity pose; and of their variants over the forward-compositional
U_FC track (``direction="forward"`` with a sigma), every feature head and
every sigma type of the encoder; ``compute_residual`` gives each track's
average residual at a given pose and level.  The one-view ``ConvRGBD``
encoder, the ``dense_net`` pose initializer, the learned ``ScaleNet``
types, weights per level, uncertainty propagation and object masks raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..geometry import warp as W
from ..ops.image import image_pyramid
from ..solvers.icp import ICPSigmaModel
from ..solvers.trust_region import (
    DirectSolver,
    tr_ic_level,
    tr_ic_residual,
    tr_icp_level,
    tr_icp_residual,
    tr_ufc_level,
    tr_ufc_residual,
    tr_uic_level,
    tr_uic_residual,
)
from .encoder import FeaturePyramid
from .layers import color_normalize_nchw, seeded_init_
from .nets import DampingRegressor, DeepRobustEstimator, ScaleNet, SFMPoseNet


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

    @property
    def predicts_init_pose(self) -> bool:
        return self.init_pose_type != "identity"


_PORTED = {
    "encoder_name": ("ConvRGBD2", "RGB", "ICP"),
    "track_type": ("U_IC", "IC", "U_FC", "ICP"),
    "mest_type": ("None", "Huber", "MultiScale2w"),
    "solver_type": ("Direct-Nodamping", "Direct-ResVol"),
    "init_pose_type": ("sfm_net", "identity"),
    "uncer_prop": (False,),
    "no_weight_sharing": (False,),
}


def _check_ported(cfg: TrackerConfig) -> None:
    for key, values in _PORTED.items():
        if getattr(cfg, key) not in values:
            raise NotImplementedError(
                f"TrackerConfig.{key}={getattr(cfg, key)!r} is not ported "
                f"(ported: {', '.join(map(repr, values))})")
    if cfg.encoder_name != "ConvRGBD2" and cfg.predicts_init_pose:
        raise NotImplementedError(
            f"a predicted initial pose over the {cfg.encoder_name} encoder is not ported")


# sigma types whose channels are copies of channel 0: the encoder repeats a
# 1-channel head to every feature channel, and "identity" is all-ones
_BCAST_SIGMA_TYPES = ("gaussian", "laplacian", "sigmoid", "old_gaussian", "old_laplacian",
                      "identity")


class LeastSquareTracking(nn.Module):
    """Deep probabilistic feature-metric tracker.

    In eval mode (the default) ``forward(img0, img1, depth0, depth1, K)``
    returns the final pose ``(R [B,3,3], t [B,3])``.  After ``.train()`` it
    returns the pose pyramid ``(pyr_R [B,N,3,3], pyr_t [B,N,3])``: the
    predicted initial pose (with ``train_init_pose``; N=5), then the pose
    after each level 3 -> 0.

    :param plain_kernels: run the plain PyTorch versions of the CUDA
        kernels, on any device (for comparison on the card)
    """

    def __init__(self, cfg: TrackerConfig = TrackerConfig(), plain_kernels: bool = False):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.plain_kernels = plain_kernels
        self.encoder = None
        if cfg.encoder_name == "ConvRGBD2":
            self.encoder = FeaturePyramid(
                in_channels=8,
                feature_channel=cfg.feature_channel,
                uncertainty_channel=cfg.uncertainty_channel,
                feature_extract=cfg.feature_extract,
                uncertainty_type=cfg.uncertainty_type,
            )
        # the reference's module names: mEst_func.net.{i}, solver_func.net.{i}.0
        self.mEst_func = DeepRobustEstimator(cfg.mest_type, feature_channel=cfg.feature_channel)
        self.solver_func = None
        if cfg.solver_type == "Direct-ResVol":
            self.solver_func = DampingRegressor(36 + 6 * cfg.tr_samples)
        self.scaler_func = ScaleNet(
            cfg.scaler, scale=cfg.scale_scaler if cfg.scale_scaler is not None else 0.01)
        self.pose_predictor = None
        if cfg.predicts_init_pose:
            self.pose_predictor = SFMPoseNet(
                in_channels=2 * 128,
                scale_motion=cfg.scale_init_pose,
                multi_hypo=cfg.multi_hypo,
                res_input=cfg.res_input,
            )
        self.eval()  # eval by default; .train() selects the training forward

    def reset_parameters(self, seed: int = 0) -> "LeastSquareTracking":
        """Seeded init of every weight, drawn on the CPU so that the same
        seed gives the same weights on every device; nothing to do for a
        tracker without weights (``RGB``, ``ICP``, ``RGB+ICP``)."""
        param = next(self.parameters(), None)
        if param is None:
            return self
        device = param.device
        self.to("cpu")
        seeded_init_(self, torch.Generator().manual_seed(seed))
        return self.to(device)

    def _slim_sigma(self, sigmas):
        """Keep one channel of a broadcast sigma: the encoder repeats a
        1-channel head to every feature channel ("identity" is all-ones),
        and bilinear warping is per-channel linear, so the warp operand
        shrinks (C=17 to C=10 in ``feature``, 49 to 28 in its U_FC variant)
        with identical values.  A sigma of another type (``feature``: a
        head per channel) stays whole; the grayscale encoders' sigma has one
        channel already; a sigma of None stays None."""
        cfg = self.cfg
        if cfg.uncertainty_type not in _BCAST_SIGMA_TYPES:
            return sigmas
        if cfg.uncertainty_type != "identity" and cfg.uncertainty_channel != 1:
            return sigmas
        return [None if s is None else s[:, :1] for s in sigmas]

    @staticmethod
    def _encode_gray(I):
        """The ``RGB`` / ``ICP`` encoder: the grayscale of the normalized
        colors, avg-pooled to four levels, with all-ones sigma."""
        x = image_pyramid((I[:, 0] * 0.299 + I[:, 1] * 0.587 + I[:, 2] * 0.114)[:, None])
        return x, [torch.ones_like(a) for a in x]

    def _preprocess(self, img0, img1, depth0, depth1, pose_init=None):
        cfg = self.cfg
        invD0 = torch.clamp(1.0 / depth0, 0.0, 10.0)
        invD1 = torch.clamp(1.0 / depth1, 0.0, 10.0)
        # zero out truncated inverse depths (batch-global min/max)
        invD0 = invD0.masked_fill((invD0 == invD0.amin()) | (invD0 == invD0.amax()), 0.0)
        invD1 = invD1.masked_fill((invD1 == invD1.amin()) | (invD1 == invD1.amax()), 0.0)
        I0 = color_normalize_nchw(img0)
        I1 = color_normalize_nchw(img1)

        if self.encoder is None:
            x0, sigma0 = self._encode_gray(I0)
            x1, sigma1 = self._encode_gray(I1)
        else:
            m0 = torch.cat([I0, invD0, I1, invD1], dim=1)
            m1 = torch.cat([I1, invD1, I0, invD0], dim=1)
            if self.training:
                # two encoder passes: each normalizes with its own batch
                # statistics and the running statistics chain through both
                x0, sigma0, raw0 = self.encoder(m0)
                x1, sigma1, raw1 = self.encoder(m1)
            else:
                # both view orders in ONE stacked encoder pass (eval
                # BatchNorm makes the two halves independent)
                B = img0.shape[0]
                f_all, s_all, raw_all = self.encoder(torch.cat([m0, m1], dim=0))
                x0, x1 = [f[:B] for f in f_all], [f[B:] for f in f_all]
                sigma0 = [None if s is None else s[:B] for s in s_all]
                sigma1 = [None if s is None else s[B:] for s in s_all]
                raw0, raw1 = [r[:B] for r in raw_all], [r[B:] for r in raw_all]
        inv_d0 = image_pyramid(invD0, pool="max")
        inv_d1 = image_pyramid(invD1, pool="max")
        if cfg.track_type in ("U_FC", "ICP") or cfg.combine_icp:
            dpt0 = image_pyramid(depth0, pool="max")
            dpt1 = image_pyramid(depth1, pool="max")
        else:
            dpt0 = dpt1 = [None] * 4
        if pose_init is not None:
            pose = pose_init
        elif self.pose_predictor is not None:
            pose = self.pose_predictor(raw0[3], raw1[3])
        else:
            B = img0.shape[0]
            pose = (torch.eye(3, dtype=invD0.dtype, device=invD0.device).repeat(B, 1, 1),
                    invD0.new_zeros((B, 3)))
        return (x0, x1, self._slim_sigma(sigma0), self._slim_sigma(sigma1), inv_d0, inv_d1,
                dpt0, dpt1, pose)

    def _mest(self, residual, x0, x1, w_prior):
        """The M-estimator weights of one IC level."""
        return self.mEst_func(residual, x0, x1, w_prior, plain=self.plain_kernels)

    def _solver(self) -> DirectSolver:
        """The IC track's solve, as the JAX ``_solver``."""
        cfg = self.cfg
        if self.solver_func is None:
            return DirectSolver("nodamping", cfg.direction)
        return DirectSolver("resvol", cfg.direction, cfg.tr_samples, self.solver_func)

    def _level_update(self, pose, x0, x1, sigma0, sigma1, invD0, invD1, dpt0, dpt1, K,
                      w_prior):
        """One pyramid level of the configured track: ``(pose, weights)``."""
        cfg = self.cfg
        track = cfg.track_type
        if track == "U_IC":
            # ScaleNet("None") reads only the shape of the ICP residual at
            # the incoming pose, [B,1,H,W] like invD0: the residual is not
            # computed
            w_icp = self.scaler_func(invD0, None, w_prior) if cfg.combine_icp else None
            pose, weights, _ = tr_uic_level(
                pose, x0, x1, invD0, invD1, K, sigma0, sigma1,
                depth0=dpt0, depth1=dpt1, w_icp=w_icp,
                max_iter=cfg.max_iter_per_pyr, remove_tru_sigma=cfg.remove_tru_sigma,
                plain=self.plain_kernels,
            )
        elif track == "IC":
            pose, weights, _ = tr_ic_level(
                pose, x0, x1, invD0, invD1, K, self._mest, self._solver(), w_prior=w_prior,
                max_iter=cfg.max_iter_per_pyr, plain=self.plain_kernels,
            )
        elif track == "U_FC":
            # in training the estimator runs once more, at the zero
            # residual: a learned one's BatchNorm statistics then move
            # 1 + max_iter times a level, as in the JAX package
            pose, weights, _ = tr_ufc_level(
                pose, x0, x1, dpt0, dpt1, K, sigma0, sigma1, self._mest, self._solver(),
                w_prior=w_prior, max_iter=cfg.max_iter_per_pyr, train=self.training,
                plain=self.plain_kernels,
            )
        else:  # ICP
            pose, weights, _ = tr_icp_level(
                pose, dpt0, dpt1, K, w_prior=w_prior, max_iter=cfg.max_iter_per_pyr,
                direction=cfg.direction, sigma_model=ICPSigmaModel(baseline=1.0),
                plain=self.plain_kernels,
            )
        return pose, weights

    def forward(self, img0, img1, depth0, depth1, K, pose_init=None):
        """:param img0/img1: [B,3,H,W] RGB in [0,1]
        :param depth0/depth1: [B,1,H,W] metric depth
        :param K: [B,4] intrinsics [fx,fy,cx,cy]
        :param pose_init: ``(R [B,3,3], t [B,3])`` to start from instead of
            the predicted initial pose or the identity
        :return: eval: final pose (R, t); training: (pyr_R, pyr_t)
        """
        x0, x1, sigma0, sigma1, inv_d0, inv_d1, dpt0, dpt1, pose = self._preprocess(
            img0, img1, depth0, depth1, pose_init)
        poses = [pose] if self.cfg.predicts_init_pose and self.cfg.train_init_pose else []
        w_prior = torch.ones_like(inv_d0[3]) * 0.001
        for level in (3, 2, 1, 0):
            pose, w_prior = self._level_update(
                pose, x0[level], x1[level], sigma0[level], sigma1[level], inv_d0[level],
                inv_d1[level], dpt0[level], dpt1[level], W.scale_K(K, level), w_prior)
            poses.append(pose)
        if self.training:
            return torch.stack([R for R, _ in poses], 1), torch.stack([t for _, t in poses], 1)
        return pose

    def compute_residual(self, img0, img1, depth0, depth1, K, pose_init=None, level: int = 0,
                         obj_mask0=None, obj_mask1=None):
        """The configured track's average residual at one pose and level
        (the convergence-basin study), from the encoded pair.

        :param pose_init: ``(R, t)``; without it the predicted initial pose
            or the identity
        :return: ``(pose, avg_residual [B])``
        """
        if obj_mask0 is not None or obj_mask1 is not None:
            raise NotImplementedError("object masks are not ported (ROADMAP item 3)")
        cfg = self.cfg
        x0, x1, sigma0, sigma1, inv_d0, inv_d1, dpt0, dpt1, pose = self._preprocess(
            img0, img1, depth0, depth1, pose_init)
        i = level
        K_i = W.scale_K(K, i)
        track = cfg.track_type
        if track == "U_IC":
            w_prior = torch.ones_like(inv_d0[i]) * 0.01
            # ScaleNet("None") reads only the ICP residual's shape
            w_icp = self.scaler_func(inv_d0[i], None, w_prior) if cfg.combine_icp else None
            loss = tr_uic_residual(
                pose, x0[i], x1[i], inv_d0[i], inv_d1[i], K_i, sigma0[i], sigma1[i],
                depth0=dpt0[i], depth1=dpt1[i], w_icp=w_icp,
                remove_tru_sigma=cfg.remove_tru_sigma, plain=self.plain_kernels)
        elif track == "IC":
            loss = tr_ic_residual(pose, x0[i], x1[i], inv_d0[i], inv_d1[i], K_i, self._mest,
                                  w_prior=torch.ones_like(inv_d0[i]), plain=self.plain_kernels)
        elif track == "U_FC":
            loss = tr_ufc_residual(pose, x0[i], x1[i], dpt0[i], dpt1[i], K_i, sigma0[i],
                                   sigma1[i], plain=self.plain_kernels)
        else:  # ICP
            loss = tr_icp_residual(pose, dpt0[i], dpt1[i], K_i, plain=self.plain_kernels)
        return pose, loss
