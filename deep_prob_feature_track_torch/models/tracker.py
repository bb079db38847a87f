"""LeastSquareTracking: encoder + coarse-to-fine trust-region solve.

Counterpart of ``deep_prob_feature_track_tpu/models/tracker.py``: every
``TrackerConfig`` value the JAX package accepts.  The encoders: the
two-view ``ConvRGBD2`` (both view orders in one stacked pass in eval), the
one-view ``ConvRGBD`` (two passes, one a frame) and the grayscale ``RGB`` /
``ICP`` pyramids, with every feature head and sigma type.  The tracks: U_IC
(with the fused ICP term of ``combine_icp``, weighted by a constant or a
learned ``ScaleNet``), IC (with the ``None``, ``Huber`` or learned
M-estimator and the ``Direct-Nodamping`` or ``Direct-ResVol`` solve), U_FC
and the stand-alone point-to-plane ICP.  The initial pose: the identity,
``SFMPoseNet`` (``multi_hypo`` ``prob_fuse``, ``average`` or ``None``, with
or without ``res_input``) or the ``dense_net`` ``PoseNet``, over any
encoder.  With ``no_weight_sharing`` each level has its own M-estimator,
scale net and damping regressor; with ``uncer_prop`` the forward also
returns the levels' 6x6 information matrices.  Every configuration takes
object masks (the relative motion of an object between two frames, given
its masks in both): the forward, ``compute_residual`` (each track's average
residual at a given pose and level) and ``track_diagnostics`` (the
per-level maps that the evaluate CLI's ``--save_img`` draws).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..geometry import warp as W
from ..ops.image import image_pyramid
from ..parallel.mesh import extrema_mask
from ..solvers.icp import ICPSigmaModel
from ..solvers.residuals import (
    build_inverse_warp_operand,
    compute_inverse_residuals,
    compute_warped_residual,
)
from ..solvers.trust_region import (
    DirectSolver,
    _warp_forward_depth,
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
from .nets import DampingRegressor, DeepRobustEstimator, PoseNet, ScaleNet, SFMPoseNet


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


_ENCODERS = ("RGB", "ConvRGBD", "ConvRGBD2", "ICP")
_INIT_POSES = ("identity", "sfm_net", "dense_net")
# the raw level-3 features that the pose initializer reads, per frame
_RAW_CHANNELS = {"ConvRGBD": 128, "ConvRGBD2": 128, "RGB": 1, "ICP": 1}


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
        cfg.track_type  # raises on an unsupported (uncertainty, direction) pair
        if cfg.encoder_name not in _ENCODERS:
            raise ValueError(f"unknown encoder_name {cfg.encoder_name!r}")
        if cfg.init_pose_type not in _INIT_POSES:
            raise ValueError(f"unknown init_pose_type {cfg.init_pose_type!r}")
        self.cfg = cfg
        self.plain_kernels = plain_kernels
        self.encoder = None
        if cfg.encoder_name in ("ConvRGBD", "ConvRGBD2"):
            self.encoder = FeaturePyramid(
                in_channels=8 if cfg.encoder_name == "ConvRGBD2" else 4,
                feature_channel=cfg.feature_channel,
                uncertainty_channel=cfg.uncertainty_channel,
                feature_extract=cfg.feature_extract,
                uncertainty_type=cfg.uncertainty_type,
            )
        # the reference's module names: mEst_func.net.{i}, scaler_func.net.{i},
        # solver_func.net.{i}.0; with no_weight_sharing one of each a level,
        # mEst_func{l}, scaler_func{l}, solver_func{l}
        scale = cfg.scale_scaler if cfg.scale_scaler is not None else 0.01
        makers = {"mEst_func": lambda: DeepRobustEstimator(cfg.mest_type,
                                                           feature_channel=cfg.feature_channel),
                  "scaler_func": lambda: ScaleNet(cfg.scaler, scale=scale)}
        if cfg.solver_type == "Direct-ResVol":
            makers["solver_func"] = lambda: DampingRegressor(36 + 6 * cfg.tr_samples)
        else:
            self.solver_func = None
        for name, make in makers.items():
            if cfg.no_weight_sharing:
                for level in range(4):
                    setattr(self, f"{name}{level}", make())
            else:
                setattr(self, name, make())
        self.pose_predictor = None
        raw_c = _RAW_CHANNELS[cfg.encoder_name]
        if cfg.init_pose_type == "sfm_net":
            self.pose_predictor = SFMPoseNet(
                in_channels=(3 if cfg.res_input else 2) * raw_c,
                scale_motion=cfg.scale_init_pose,
                multi_hypo=cfg.multi_hypo,
                res_input=cfg.res_input,
            )
        elif cfg.init_pose_type == "dense_net":
            self.pose_predictor = PoseNet(raw_c, scale_motion=cfg.scale_init_pose)
        self.eval()  # eval by default; .train() selects the training forward

    def _instance(self, name: str, level: int):
        """The level's M-estimator, scale net or damping regressor (``name``
        ``mEst_func``, ``scaler_func`` or ``solver_func``): one a level
        with ``no_weight_sharing``, else the shared one."""
        return getattr(self, f"{name}{level}" if self.cfg.no_weight_sharing else name)

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

    def _preprocess(self, img0, img1, depth0, depth1, pose_init=None, obj_mask0=None,
                    obj_mask1=None):
        """The encoded pair, its pyramids and the initial pose: ``(x0, x1,
        sigma0, sigma1, inv_d0, inv_d1, dpt0, dpt1, m0, m1, pose)``, each
        but the pose a list over the four levels; ``m0``/``m1`` are the
        object masks' bool pyramids (a window with any object pixel is
        object), or Nones."""
        cfg = self.cfg
        invD0 = torch.clamp(1.0 / depth0, 0.0, 10.0)
        invD1 = torch.clamp(1.0 / depth1, 0.0, 10.0)
        # zero out truncated inverse depths (batch-global min/max)
        invD0 = invD0.masked_fill(extrema_mask(invD0), 0.0)
        invD1 = invD1.masked_fill(extrema_mask(invD1), 0.0)
        I0 = color_normalize_nchw(img0)
        I1 = color_normalize_nchw(img1)

        if self.encoder is None:
            x0, sigma0 = self._encode_gray(I0)
            x1, sigma1 = self._encode_gray(I1)
            raw0, raw1 = x0, x1
        elif cfg.encoder_name == "ConvRGBD":
            # one view a pass, in eval as in training
            x0, sigma0, raw0 = self.encoder(torch.cat([I0, invD0], dim=1))
            x1, sigma1, raw1 = self.encoder(torch.cat([I1, invD1], dim=1))
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
        m0 = image_pyramid(obj_mask0.bool()) if obj_mask0 is not None else [None] * 4
        m1 = image_pyramid(obj_mask1.bool()) if obj_mask1 is not None else [None] * 4
        if pose_init is not None:
            pose = pose_init
        elif self.pose_predictor is not None:
            pose = self.pose_predictor(raw0[3], raw1[3])
        else:
            B = img0.shape[0]
            pose = (torch.eye(3, dtype=invD0.dtype, device=invD0.device).repeat(B, 1, 1),
                    invD0.new_zeros((B, 3)))
        return (x0, x1, self._slim_sigma(sigma0), self._slim_sigma(sigma1), inv_d0, inv_d1,
                dpt0, dpt1, m0, m1, pose)

    def _mest_at(self, level: int):
        """The M-estimator weights of one IC or U_FC level, as a function
        ``(residual, x0, x1, w_prior) -> weights``."""
        mest = self._instance("mEst_func", level)

        def fn(residual, x0, x1, w_prior):
            return mest(residual, x0, x1, w_prior, plain=self.plain_kernels)

        return fn

    def _scale_fn(self, level: int):
        """The level's ICP weights as a function of the ICP and feature
        residuals and the prior weights (``ScaleNet``), or None without the
        fused ICP term."""
        if not self.cfg.combine_icp:
            return None
        scaler = self._instance("scaler_func", level)

        def scale_fn(icp_res, feat_res, w_prior):
            return scaler(icp_res, feat_res, w_prior, plain=self.plain_kernels)

        return scale_fn

    def _solver(self, level: int) -> DirectSolver:
        """The IC track's solve, as the JAX ``_solver``."""
        cfg = self.cfg
        if cfg.solver_type != "Direct-ResVol":
            return DirectSolver("nodamping", cfg.direction)
        return DirectSolver("resvol", cfg.direction, cfg.tr_samples,
                            self._instance("solver_func", level))

    def _level_update(self, level, pose, x0, x1, sigma0, sigma1, invD0, invD1, dpt0, dpt1, K,
                      w_prior, m0=None, m1=None):
        """One pyramid level of the configured track, with the level's
        object masks ``m0``/``m1`` where given: ``(pose, weights, JtWJ)``."""
        cfg = self.cfg
        track = cfg.track_type
        if track == "U_IC":
            return tr_uic_level(
                pose, x0, x1, invD0, invD1, K, sigma0, sigma1,
                depth0=dpt0, depth1=dpt1, obj_mask0=m0, obj_mask1=m1,
                max_iter=cfg.max_iter_per_pyr, remove_tru_sigma=cfg.remove_tru_sigma,
                plain=self.plain_kernels, scale_fn=self._scale_fn(level), w_prior=w_prior,
            )
        if track == "IC":
            return tr_ic_level(
                pose, x0, x1, invD0, invD1, K, self._mest_at(level), self._solver(level),
                w_prior=w_prior, obj_mask0=m0, obj_mask1=m1, max_iter=cfg.max_iter_per_pyr,
                plain=self.plain_kernels,
            )
        if track == "U_FC":
            # in training the estimator runs once more, at the zero
            # residual: a learned one's BatchNorm statistics then move
            # 1 + max_iter times a level, as in the JAX package
            return tr_ufc_level(
                pose, x0, x1, dpt0, dpt1, K, sigma0, sigma1, self._mest_at(level),
                self._solver(level), w_prior=w_prior, obj_mask0=m0, obj_mask1=m1,
                max_iter=cfg.max_iter_per_pyr, train=self.training, plain=self.plain_kernels,
            )
        # ICP
        return tr_icp_level(
            pose, dpt0, dpt1, K, w_prior=w_prior, obj_mask1=m1, max_iter=cfg.max_iter_per_pyr,
            direction=cfg.direction, sigma_model=ICPSigmaModel(baseline=1.0),
            plain=self.plain_kernels,
        )

    def forward(self, img0, img1, depth0, depth1, K, pose_init=None, obj_mask0=None,
                obj_mask1=None):
        """:param img0/img1: [B,3,H,W] RGB in [0,1]
        :param depth0/depth1: [B,1,H,W] metric depth
        :param K: [B,4] intrinsics [fx,fy,cx,cy]
        :param pose_init: ``(R [B,3,3], t [B,3])`` to start from instead of
            the predicted initial pose or the identity
        :param obj_mask0/obj_mask1: [B,1,H,W] bool object masks of the two
            frames: the pose is then the object's relative motion
        :return: eval: the final pose ``(R, t)``, with ``uncer_prop``
            ``((R, t), JtWJ [B,6,6])``, level 0's information matrix;
            training: ``(pyr_R, pyr_t)``, with ``uncer_prop`` ``(pyr_R,
            pyr_t, sigma_ksi [B,N,6,6])``, each level's JtWJ (after an
            identity for the predicted initial pose with ``train_init_pose``)
        """
        cfg = self.cfg
        x0, x1, sigma0, sigma1, inv_d0, inv_d1, dpt0, dpt1, m0, m1, pose = self._preprocess(
            img0, img1, depth0, depth1, pose_init, obj_mask0, obj_mask1)
        poses, infos = [], []
        if cfg.predicts_init_pose and cfg.train_init_pose:
            poses.append(pose)
            B = inv_d0[0].shape[0]
            infos.append(torch.eye(6, dtype=inv_d0[0].dtype, device=inv_d0[0].device)
                         .expand(B, 6, 6))
        w_prior = torch.ones_like(inv_d0[3]) * 0.001
        for level in (3, 2, 1, 0):
            pose, w_prior, JtWJ = self._level_update(
                level, pose, x0[level], x1[level], sigma0[level], sigma1[level], inv_d0[level],
                inv_d1[level], dpt0[level], dpt1[level], W.scale_K(K, level), w_prior,
                m0[level], m1[level])
            poses.append(pose)
            infos.append(JtWJ)
        if self.training:
            pyr = (torch.stack([R for R, _ in poses], 1), torch.stack([t for _, t in poses], 1))
            return (*pyr, torch.stack(infos, 1)) if cfg.uncer_prop else pyr
        return (pose, JtWJ) if cfg.uncer_prop else pose

    def compute_residual(self, img0, img1, depth0, depth1, K, pose_init=None, level: int = 0,
                         obj_mask0=None, obj_mask1=None):
        """The configured track's average residual at one pose and level
        (the convergence-basin study), from the encoded pair.  The object
        masks reach the U_IC feature residual and the IC residual; the U_FC
        and ICP residuals take none, as in the JAX function.

        :param pose_init: ``(R, t)``; without it the predicted initial pose
            or the identity
        :return: ``(pose, avg_residual [B])``
        """
        cfg = self.cfg
        x0, x1, sigma0, sigma1, inv_d0, inv_d1, dpt0, dpt1, m0, m1, pose = self._preprocess(
            img0, img1, depth0, depth1, pose_init, obj_mask0, obj_mask1)
        i = level
        K_i = W.scale_K(K, i)
        track = cfg.track_type
        if track == "U_IC":
            loss = tr_uic_residual(
                pose, x0[i], x1[i], inv_d0[i], inv_d1[i], K_i, sigma0[i], sigma1[i],
                depth0=dpt0[i], depth1=dpt1[i], obj_mask0=m0[i], obj_mask1=m1[i],
                remove_tru_sigma=cfg.remove_tru_sigma, plain=self.plain_kernels,
                scale_fn=self._scale_fn(i), w_prior=torch.ones_like(inv_d0[i]) * 0.01)
        elif track == "IC":
            loss = tr_ic_residual(pose, x0[i], x1[i], inv_d0[i], inv_d1[i], K_i, self._mest_at(i),
                                  w_prior=torch.ones_like(inv_d0[i]), obj_mask0=m0[i],
                                  obj_mask1=m1[i], plain=self.plain_kernels)
        elif track == "U_FC":
            loss = tr_ufc_residual(pose, x0[i], x1[i], dpt0[i], dpt1[i], K_i, sigma0[i],
                                   sigma1[i], plain=self.plain_kernels)
        else:  # ICP
            loss = tr_icp_residual(pose, dpt0[i], dpt1[i], K_i, plain=self.plain_kernels)
        return pose, loss

    def track_diagnostics(self, img0, img1, depth0, depth1, K, obj_mask0=None, obj_mask1=None):
        """The eval forward, with per-level maps for the evaluate CLI's
        ``--save_img`` (``utils/display``): the encoded feature and sigma
        pyramids, and at each level's final pose the weighted residual map,
        its invalid mask, the pose and where a strided grid of frame-0
        pixels lands in frame 1.  The residual map is the track's own: the
        U_IC (with the masks, one gather of the C=11 operand) or IC residual
        (with both masks); for U_FC the uncertainty-normalized residual of
        the forward warp, and for ICP the warped depth's discrepancy, both
        without masks, as in the JAX function.

        :return: ``(pose, diag)``: ``diag`` maps ``features0/1``,
            ``sigma0/1`` (broadcast to the feature channels), ``residual``,
            ``invalid`` (bool), ``poses`` (``(R, t)``) and ``matches``
            (``(coords [B,2,N], valid [B,N])``) to lists indexed by level
            (0 = finest)
        """
        cfg = self.cfg
        x0, x1, sigma0, sigma1, inv_d0, inv_d1, dpt0, dpt1, m0, m1, pose = self._preprocess(
            img0, img1, depth0, depth1, None, obj_mask0, obj_mask1)

        def viz_sigma(sigmas, feats):
            return [s if s is None or s.shape[1] == f.shape[1] else s.expand_as(f)
                    for s, f in zip(sigmas, feats)]

        diag = {"features0": x0, "features1": x1, "sigma0": viz_sigma(sigma0, x0),
                "sigma1": viz_sigma(sigma1, x1), **{k: [None] * 4 for k in (
                    "residual", "invalid", "poses", "matches")}}
        plain = self.plain_kernels
        w_prior = torch.ones_like(inv_d0[3]) * 0.001
        for level in (3, 2, 1, 0):
            K_l = W.scale_K(K, level)
            pose, w_prior, _ = self._level_update(
                level, pose, x0[level], x1[level], sigma0[level], sigma1[level], inv_d0[level],
                inv_d1[level], dpt0[level], dpt1[level], K_l, w_prior, m0[level], m1[level])
            B, _, H, W_ = inv_d0[level].shape
            track = cfg.track_type
            if track in ("U_IC", "IC"):
                px, py = W.generate_xy_grid(B, H, W_, K_l)
                u, v, _ = W.batch_warp_inverse_depth(px, py, inv_d0[level], pose, K_l)
                if track == "U_IC":
                    out, _, _ = compute_inverse_residuals(
                        pose, inv_d0[level], x0[level], sigma0[level], px, py, K_l,
                        build_inverse_warp_operand(inv_d1[level], x1[level], sigma1[level],
                                                   m1[level]),
                        obj_mask0=m0[level], remove_tru_sigma=cfg.remove_tru_sigma,
                        plain=plain)
                    res_map, invalid = out.weighted_res, out.invalid
                else:
                    res_map, invalid = compute_warped_residual(
                        pose, inv_d0[level], inv_d1[level], x0[level], x1[level], px, py, K_l,
                        m0[level], m1[level], plain=plain)
            else:
                u, v, dpt_r, depth_valid, _, _ = _warp_forward_depth(dpt0[level], pose, K_l)
                if track == "U_FC":
                    dpt1_w, f_r, s_r = W.warp_multi([dpt1[level], x1[level], sigma1[level]],
                                                    u, v, plain=plain)
                    sig = torch.sqrt(s_r * s_r + sigma0[level] * sigma0[level])
                    invalid = W.check_occ_prewarped(dpt_r, dpt1_w, u, v) | ~depth_valid
                    res_map = ((f_r - x0[level]) / sig).masked_fill(invalid, 1e-6)
                else:  # ICP: the warped depth's discrepancy
                    dpt1_w = W.warp_features(dpt1[level], u, v, plain=plain)
                    invalid = W.check_occ_prewarped(dpt_r, dpt1_w, u, v) | ~depth_valid
                    res_map = (dpt1_w - dpt_r).masked_fill(invalid, 0.0)
            sh, sw = max(H // 8, 1), max(W_ // 8, 1)
            grid = (u[:, 0, ::sh, ::sw].reshape(B, -1), v[:, 0, ::sh, ::sw].reshape(B, -1))
            diag["matches"][level] = (torch.stack(grid, dim=1),
                                      ~invalid[:, 0, ::sh, ::sw].reshape(B, -1))
            diag["residual"][level] = res_map
            diag["invalid"][level] = invalid
            diag["poses"][level] = pose
        return pose, diag
