"""Non-learned baseline trackers with the ``batch_track`` duck-type.

Counterpart of ``deep_prob_feature_track_tpu/apps/baselines.py``: the
classical objectives of the paper's comparison tables (multiscale
point-to-plane ICP, point-to-point ICP, photometric and hybrid RGB-D
odometry) run batched over pairs on the port's own level solves, behind
``batch_track(color0, depth0, color1, depth1, K) -> (R, t)``.  Every track
starts at the identity.  The divergence guard (``||t|| > 1`` resets that
sample to the identity) runs on the device, without a host sync; as in the
JAX package it lets a NaN pose through, so that a failed Cholesky solve
stays visible.

Kernels: an ICP or photometric iteration warps once with K1 (K4 where
``use_tiles`` holds, as for the ICP operand at 640x480 level 0), a hybrid
one twice; a photometric iteration reduces its system with K6.  ``plain``
runs the kernels' plain versions on any device, for comparison.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..geometry.warp import scale_K
from ..models.layers import color_normalize_nchw
from ..ops.image import image_pyramid
from ..solvers.icp import ICPSigmaModel
from ..solvers.trust_region import tr_icp_level, tr_icp_point_level, tr_uic_level

# the iterative plans' (level, iterations) over 3 scales
ITER_SCHEDULE = ((2, 50), (1, 30), (0, 14))
LEVELS = (3, 2, 1, 0)  # the pyramid levels of the multiscale plans
ICP_SCALE = 0.2  # the hybrid term's fixed ICP weight


def _identity(depth):
    B = depth.shape[0]
    return (torch.eye(3, dtype=depth.dtype, device=depth.device).repeat(B, 1, 1),
            depth.new_zeros((B, 3)))


class _BaseTracker:
    def __init__(self, plain: bool = False):
        self.plain = plain

    def track(self, color0, depth0, color1, depth1, K):
        raise NotImplementedError

    def batch_track(self, color0, depth0, color1, depth1, K, batch_objmask0=None,
                    batch_objmask1=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """:return: ``(R [B,3,3], t [B,3])`` on the inputs' device; a
        sample whose ``||t||`` exceeds 1 comes back as the identity, a NaN
        one (a damped system that is not positive definite in float32)
        as NaN.  The object masks are taken and ignored, as the JAX
        baselines ignore them: a baseline tracks the whole frame."""
        R, t = self.track(color0, depth0, color1, depth1, K)
        bad = torch.linalg.vector_norm(t, dim=-1) > 1.0
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        return torch.where(bad[:, None, None], eye, R), t.masked_fill(bad[:, None], 0.0)


class ICPOdometry(_BaseTracker):
    """Geometric ICP baselines.

    ``mode``:

    * ``'Point2Plane'``: inverse point-to-plane ICP, ``max_iter``
      iterations on each of :data:`LEVELS`;
    * ``'Point2Point'``: forward point-to-point ICP with projective
      association, 10 iterations at level 2 (``dist_thr`` 0.10) to enter
      the basin, then 30 at level 0 (0.05);
    * ``'Iter_Point2Plane'``: point-to-plane over :data:`ITER_SCHEDULE`.
    """

    def __init__(self, mode: str = "Point2Plane", max_iter: int = 10, plain: bool = False):
        super().__init__(plain)
        if mode not in ("Point2Plane", "Point2Point", "Iter_Point2Plane"):
            raise NotImplementedError(mode)
        self.mode = mode
        self.schedule = (ITER_SCHEDULE if mode == "Iter_Point2Plane"
                         else tuple((lvl, max_iter) for lvl in LEVELS))

    def track(self, color0, depth0, color1, depth1, K):
        d0 = image_pyramid(depth0, pool="max")
        d1 = image_pyramid(depth1, pool="max")
        pose = _identity(depth0)
        if self.mode == "Point2Point":
            pose, _ = tr_icp_point_level(pose, d0[2], d1[2], scale_K(K, 2), max_iter=10,
                                         dist_thr=0.10, plain=self.plain)
            pose, _ = tr_icp_point_level(pose, d0[0], d1[0], K, max_iter=30, dist_thr=0.05,
                                         plain=self.plain)
            return pose
        for lvl, iters in self.schedule:
            pose, _, _ = tr_icp_level(pose, d0[lvl], d1[lvl], scale_K(K, lvl), max_iter=iters,
                                      direction="inverse",
                                      sigma_model=ICPSigmaModel(baseline=1.0), plain=self.plain)
        return pose


class RGBDOdometry(_BaseTracker):
    """Photometric (``term="color"``) or hybrid RGB-D odometry: grayscale
    inverse-compositional Gauss-Newton with unit sigma, and in ``hybrid``
    the point-to-plane ICP term fused into the same normal equations with
    the fixed weight :data:`ICP_SCALE`.  ``schedule`` is the (level,
    iterations) plan; by default ``max_iter`` on each of :data:`LEVELS`."""

    def __init__(self, term: str = "hybrid", max_iter: int = 10,
                 schedule: Optional[Sequence[Tuple[int, int]]] = None, plain: bool = False):
        super().__init__(plain)
        if term not in ("color", "hybrid"):
            raise ValueError(f"unknown term {term!r}: use 'color' or 'hybrid'")
        self.term = term
        self.schedule = (tuple(schedule) if schedule is not None
                         else tuple((lvl, max_iter) for lvl in LEVELS))

    def track(self, color0, depth0, color1, depth1, K):
        def gray(color):
            I = color_normalize_nchw(color)
            return (I[:, 0] * 0.299 + I[:, 1] * 0.587 + I[:, 2] * 0.114)[:, None]

        f0, f1 = image_pyramid(gray(color0)), image_pyramid(gray(color1))
        iv0 = image_pyramid(torch.clamp(1.0 / depth0, 0.0, 10.0), pool="max")
        iv1 = image_pyramid(torch.clamp(1.0 / depth1, 0.0, 10.0), pool="max")
        dp0 = image_pyramid(depth0, pool="max")
        dp1 = image_pyramid(depth1, pool="max")
        pose = _identity(depth0)
        # the fixed ICP scale: a constant weight map
        scale_fn = ((lambda icp_res, *_: torch.full_like(icp_res, ICP_SCALE))
                    if self.term == "hybrid" else None)
        for lvl, iters in self.schedule:
            ones = torch.ones_like(f0[lvl])
            pose, _, _ = tr_uic_level(pose, f0[lvl], f1[lvl], iv0[lvl], iv1[lvl],
                                      scale_K(K, lvl), ones, ones, depth0=dp0[lvl],
                                      depth1=dp1[lvl], scale_fn=scale_fn, max_iter=iters,
                                      plain=self.plain)
        return pose


TRACKERS = ("ICP", "Point2Point", "Iter_Point2Plane", "RGBD", "ColorICP", "Iter_ColorICP")


def make_baseline(name: str, plain: bool = False) -> _BaseTracker:
    """The evaluate CLI's ``--tracker`` baselines by name."""
    if name == "ICP":
        return ICPOdometry(plain=plain)
    if name in ("Point2Point", "Iter_Point2Plane"):
        return ICPOdometry(mode=name, plain=plain)
    if name == "RGBD":
        return RGBDOdometry(term="hybrid", plain=plain)
    if name == "ColorICP":
        return RGBDOdometry(term="color", plain=plain)
    if name == "Iter_ColorICP":
        return RGBDOdometry(term="color", schedule=ITER_SCHEDULE, plain=plain)
    raise ValueError(f"unknown baseline {name!r}: one of {', '.join(TRACKERS)}")
