"""Warped feature-metric residuals: uncertainty-normalized (U_IC) and
plain (IC), and their average at a fixed pose.

Counterpart of ``deep_prob_feature_track_tpu/solvers/residuals.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import warp as W
from ..parallel.mesh import extrema_mask


class ResidualOutput(NamedTuple):
    weighted_res: torch.Tensor  # [B,C,H,W] res/sigma, invalid -> 1e-6
    res: torch.Tensor           # [B,C,H,W] raw residual (unmasked)
    sigma: torch.Tensor         # [B,C,H,W] combined sigma
    invalid: torch.Tensor       # [B,1,H,W] bool, True where invalid


def merge_object_masks(occ, u, v, obj_mask0=None, obj_mask1=None, plain: bool = False):
    """Fold the object masks into the invalid mask ``occ`` [B,1,H,W]:
    pixels outside the frame-0 object, and pixels whose warp (u, v) lands
    outside the frame-1 object (its bilinear sample is not > 0), are
    invalid.  ``obj_mask1`` is the frame-1 mask [B,1,H,W] or its prebuilt
    operand (``W.make_warp_operand``); it is warped in a gather of its own.
    """
    if obj_mask0 is not None:
        occ = occ | ~obj_mask0.bool()
    if obj_mask1 is not None:
        if isinstance(obj_mask1, torch.Tensor):
            obj_mask1 = W.make_warp_operand([obj_mask1.bool().to(u.dtype)])
        occ = occ | ~(W.warp_operand(*obj_mask1, u, v, plain=plain)[0] > 0)
    return occ


def compose_residuals(u, v, invalid, f0, f1, sigma0, sigma1, eps: float = 1e-6,
                      remove_tru_sigma: bool = False, plain: bool = False) -> ResidualOutput:
    """Uncertainty-normalized residual at warped coordinates (u, v):
    ``res = f1(u, v) - f0`` over ``sigma = sqrt(sigma1(u, v)^2 + sigma0^2)``,
    ``eps`` where ``invalid``; ``remove_tru_sigma`` also invalidates pixels
    where either sigma map is at its batch-global min or max.  ``f1`` and
    ``sigma1`` warp in one gather of their stacked operand (the JAX function
    warps them one by one, to the same values)."""
    f_r, sigma_r = W.warp_multi([f1, sigma1], u, v, plain=plain)
    res = f_r - f0
    sigma = torch.sqrt(sigma_r * sigma_r + sigma0 * sigma0)
    weighted = res / sigma
    if remove_tru_sigma:
        sigma_tru = extrema_mask(sigma_r) | extrema_mask(sigma0)
        invalid = invalid | sigma_tru[:, 0:1]
    return ResidualOutput(weighted.masked_fill(invalid, eps), res, sigma, invalid)


def compute_inverse_residuals(
    pose10, invD0, x0, sigma0, px, py, K, warp_op, obj_mask0=None,
    remove_tru_sigma: bool = False, plain: bool = False,
):
    """Inverse-compositional residual: warp + occlusion + compose.

    The target inverse depth, features and sigma (and the frame-1 object
    mask, where :func:`build_inverse_warp_operand` was given one) are
    warped in ONE gather of the stacked operand ``warp_op``.  Pixels
    outside the frame-0 object ``obj_mask0``, or whose warped frame-1 mask
    is not > 0, are invalid.  ``remove_tru_sigma`` also invalidates pixels
    where either sigma map is exactly at its batch-global min or max.

    :return: ``(ResidualOutput, u, v)``
    """
    u, v, inv_z = W.batch_warp_inverse_depth(px, py, invD0, pose10, K)
    warped = W.warp_operand(warp_op[0], warp_op[1], u, v, plain=plain)
    invD1_w, f_r, sigma_r = warped[:3]

    occ = W.check_occ_prewarped(inv_z, invD1_w, u, v)
    if obj_mask0 is not None:
        occ = occ | ~obj_mask0.bool()
    if len(warped) > 3:
        occ = occ | ~(warped[3] > 0)
    res = f_r - x0
    sigma = torch.sqrt(sigma_r * sigma_r + sigma0 * sigma0)
    weighted = res / sigma
    if remove_tru_sigma:
        sigma_tru = extrema_mask(sigma_r) | extrema_mask(sigma0)
        occ = occ | sigma_tru[:, 0:1]
    weighted = weighted.masked_fill(occ, 1e-6)
    return ResidualOutput(weighted, res, sigma, occ), u, v


def build_inverse_warp_operand(invD1, x1, sigma1, obj_mask1=None):
    """Stacked channels-last operand ``[invD1 | x1 | sigma1]`` of the maps
    the U_IC iteration warps, with the frame-1 object mask as one more
    channel where given (loop-invariant: built once per level)."""
    maps = [invD1, x1, sigma1]
    if obj_mask1 is not None:
        maps.append(obj_mask1.bool().to(x1.dtype))
    return W.make_warp_operand(maps)


def make_ic_operands(x1, invD1, samples: int = 1, obj_mask1=None):
    """The channels-last operands of ``x1`` and ``invD1`` that the IC
    residual warps, one gather each, as the JAX package warps them, and of
    the frame-1 object mask where given (a third gather); with ``samples``
    > 1 each plane is repeated along the batch, sample-major (index ``s * B
    + b``), for the poses of the damping samples.  Built once per level."""
    maps = [x1, invD1] if obj_mask1 is None else [x1, invD1, obj_mask1.bool().to(x1.dtype)]
    return [W.make_warp_operand([m.repeat(samples, 1, 1, 1) if samples > 1 else m])
            for m in maps]


def warped_residual(pose10, invD0, x0, px, py, K, operands, obj_mask0=None,
                    plain: bool = False):
    """:func:`compute_warped_residual` on the operands of
    :func:`make_ic_operands` (the object mask of frame 1 among them where
    they hold three); with folded operands, every argument has their
    batch."""
    u, v, inv_z = W.batch_warp_inverse_depth(px, py, invD0, pose10, K)
    x1_warped = W.warp_operand(*operands[0], u, v, plain=plain)[0]
    invD1_warped = W.warp_operand(*operands[1], u, v, plain=plain)[0]
    occ = W.check_occ_prewarped(inv_z, invD1_warped, u, v)
    occ = merge_object_masks(occ, u, v, obj_mask0, operands[2] if len(operands) > 2 else None,
                             plain=plain)
    return (x1_warped - x0).masked_fill(occ, 1e-3), occ


def compute_warped_residual(pose10, invD0, invD1, x0, x1, px, py, K,
                            obj_mask0=None, obj_mask1=None, plain: bool = False):
    """Plain warped residual ``x1(w(x)) - x0`` of the IC track, 1e-3 where
    invalid.  ``x1``, ``invD1`` (for the occlusion test) and the frame-1
    object mask warp in one gather each, as in the JAX package; the object
    masks fold in through :func:`merge_object_masks`.

    :return: ``(residuals [B,C,H,W], invalid [B,1,H,W])``
    """
    return warped_residual(pose10, invD0, x0, px, py, K,
                           make_ic_operands(x1, invD1, obj_mask1=obj_mask1),
                           obj_mask0=obj_mask0, plain=plain)


def compute_avg_loss(x_list, invalid) -> torch.Tensor:
    """Per-sample average squared residual over the valid pixels: the sum
    of ``x * x`` over every map of ``x_list`` (``[B,C,H,W]`` each, zero
    where ``invalid [B,1,H,W]``) over the valid pixel count, which counts
    at least 1, so an all-invalid sample reports 0.

    :return: [B]
    """
    B, _, H, W_ = invalid.shape
    valid_num = H * W_ - invalid.reshape(B, -1).sum(dim=1)
    total = torch.zeros((B,), dtype=x_list[0].dtype, device=invalid.device)
    for x in x_list:
        masked = x.masked_fill(invalid, 0.0)
        total = total + (masked * masked).sum(dim=(1, 2, 3))
    return total / torch.clamp(valid_num, min=1)


def compute_avg_res(x, invalid) -> torch.Tensor:
    """Whole-batch residual norm over the valid pixel count (at least 1)."""
    B, _, H, W_ = invalid.shape
    valid_num = B * H * W_ - invalid.sum()
    return torch.linalg.vector_norm(x.masked_fill(invalid, 0.0).reshape(-1)) / torch.clamp(
        valid_num, min=1)


def warp_images(invD0, pose10, img1, invD1, K, plain: bool = False):
    """Warp an image ``[B,C,H,W]`` and its inverse depth into the frame of
    ``invD0`` under ``pose10``, in one gather of their stacked operand.

    :return: ``(img1_r, invD1_r)``
    """
    B, _, H, W_ = img1.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    u, v, _ = W.batch_warp_inverse_depth(px, py, invD0, pose10, K)
    img1_r, invD1_r = W.warp_multi([img1, invD1], u, v, plain=plain)
    return img1_r, invD1_r
