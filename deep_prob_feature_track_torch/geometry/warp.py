"""Pixel grids, inverse-depth warping, bilinear sampling and the
point-cloud helpers of the training loss.

Counterpart of ``deep_prob_feature_track_tpu/geometry/warp.py`` for the
U_IC, IC and ICP tracks.  Sampling is ``grid_sample(align_corners=True,
padding_mode='border')``: coordinates clamp to ``[0, size-1]`` and blend
bilinearly.  Without autograd the gather runs through kernel K1; under
autograd :class:`BilinearGather` runs K2 in its forward and K3 in its
backward.  Where the JAX package takes its tile kernels
(``ops/kernels/tiles.py::use_tiles``: large planes such as 480x640), K4
takes K1's place and K5 takes K2's.  Each kernel takes its plain version on
CPU tensors (``ops/kernels/``); ``plain=True`` takes the plain versions on
either device.  A plane under 2x2 (no 2x2 cell fits) is sampled in tensor
ops (:func:`_bilinear_gather_tiny`), as the JAX package routes it away
from its kernels; the kernels' wrappers refuse such a plane.  Within
``utils/remat.py::bf16_maps`` (the training mode ``bf16_residuals``) the
gather keeps its derivative maps in bfloat16 for its backward.
"""

from __future__ import annotations

import math

import torch

from ..ops.kernels.gather import gather_twohot, gather_twohot_ref
from ..ops.kernels.gather_grads import gather_twohot_grads, gather_twohot_grads_ref
from ..ops.kernels.splat import splat_twohot, splat_twohot_ref
from ..ops.kernels.tiles import (
    gather_tiles,
    gather_tiles_grads,
    gather_tiles_grads_ref,
    gather_tiles_ref,
    use_tiles,
)
from ..utils.remat import keeps_bf16_maps


def generate_xy_grid(B: int, H: int, W: int, K: torch.Tensor):
    """Normalized camera-ray grid ``px=(u-cx)/fx, py=(v-cy)/fy``.

    :param K: intrinsics ``[B,4]`` as ``[fx, fy, cx, cy]``
    :return: ``(px, py)`` each ``[B,1,H,W]``
    """
    fx, fy, cx, cy = (K[:, i, None, None, None] for i in range(4))
    u = torch.arange(W, dtype=K.dtype, device=K.device)[None, None, None, :]
    v = torch.arange(H, dtype=K.dtype, device=K.device)[None, None, :, None]
    px = ((u - cx) / fx).expand(B, 1, H, W)
    py = ((v - cy) / fy).expand(B, 1, H, W)
    return px, py


def batch_warp_inverse_depth(px, py, invD0, pose10, K):
    """Warp the grid under SE(3) with inverse depth:
    ``R @ [x,y,1] + t * invD0``, projected back through K.

    :return: ``(u, v, inv_z)`` each ``[B,1,H,W]``
    """
    R, t = pose10
    B, _, H, W = px.shape
    xy1 = torch.cat([px, py, torch.ones_like(px)], dim=1).reshape(B, 3, H * W)
    warped = R @ xy1 + t[:, :, None] * invD0.reshape(B, 1, H * W)
    x_, y_, s_ = warped[:, 0], warped[:, 1], warped[:, 2]
    fx, fy, cx, cy = K[:, 0:1], K[:, 1:2], K[:, 2:3], K[:, 3:4]
    u_ = (x_ / s_) * fx + cx
    v_ = (y_ / s_) * fy + cy
    inv_z = invD0 / s_.reshape(B, 1, H, W)
    return u_.reshape(B, 1, H, W), v_.reshape(B, 1, H, W), inv_z


def check_occ_prewarped(inv_z_buffer, inv_z_warped, u, v, thres: float = 1e-1):
    """Z-buffer occlusion + out-of-view test; True where INVALID."""
    _, _, H, W = inv_z_buffer.shape
    inlier = inv_z_buffer > (inv_z_warped - thres)
    return ~(inlier & (u > 0) & (u < W) & (v > 0) & (v < H))


def _corner_weights(operand_shape, u, v):
    """Clamp to the plane, clamp the cell start to ``size-2`` so the 2x2
    window always fits, and split into (start, fraction).

    :return: ``(v0, dv, u0, du)``: int32 and f32 ``[B,N]``
    """
    B, H, W, _ = operand_shape
    uf = u.reshape(B, -1).clamp(0.0, W - 1.0)
    vf = v.reshape(B, -1).clamp(0.0, H - 1.0)
    u0 = torch.floor(uf).clamp(max=W - 2.0)
    v0 = torch.floor(vf).clamp(max=H - 2.0)
    return v0.to(torch.int32), vf - v0, u0.to(torch.int32), uf - u0


def _tiles_grid(kind, operand_shape, u):
    """The sample grid ``(h, w)`` of coordinates ``[B,...,h,w]`` when the
    JAX package would sample ``operand_shape`` on it with a tile kernel
    (``geometry/warp.py::_sample_hw`` and ``_tiles_enabled`` there), else
    None."""
    if u.ndim < 3 or math.prod(u.shape[1:-2]) != 1:
        return None
    _, H, W, C = operand_shape
    h, w = u.shape[-2:]
    return (h, w) if use_tiles(kind, H, W, C, h, w) else None


def make_warp_operand(maps):
    """Stack ``[B,Ci,H,W]`` maps into one channels-last operand.

    :return: ``(operand [B,H,W,Ctot], sizes)``
    """
    sizes = [m.shape[1] for m in maps]
    stacked = torch.cat(maps, dim=1)
    return stacked.permute(0, 2, 3, 1).contiguous(), sizes


class BilinearGather(torch.autograd.Function):
    """Differentiable sample of a channels-last operand ``[B,H,W,C]`` at raw
    coordinates ``(u, v)`` -> ``[B,C,N]``; mirrors the JAX
    ``_gather_fast_vjp`` (``geometry/warp.py:411-486``).

    The forward runs K2 (K5 where :func:`use_tiles` holds) and saves its
    derivative maps gx/gy with (u, v), not the corners or the operand: the
    backward needs only the operand's shape.
    The backward contracts the cotangent with gx/gy for the coordinate
    cotangents, zeroed outside the closed interval ``[0, size-1]`` (the
    clamp's VJP), and splats the operand cotangent with K3.

    Within ``utils/remat.py::bf16_maps`` K2 or K5 write gx/gy in bfloat16
    (their bf16 mode), each rounded once to nearest even, half the bytes the
    backward keeps alive, as the JAX package's ``DPFT_BF16_RESIDUALS=1``
    does (``geometry/warp.py:176-185`` there).  They feed only the coordinate
    cotangents; the operand cotangent (K3) does not read them.
    """

    @staticmethod
    def forward(ctx, operand, u, v, plain: bool):
        starts = _corner_weights(operand.shape, u, v)
        grid = _tiles_grid("grads", operand.shape, u)
        if grid is not None:
            grads = gather_tiles_grads_ref if plain else gather_tiles_grads
            starts = [t.reshape(-1, *grid) for t in starts]
        else:
            grads = gather_twohot_grads_ref if plain else gather_twohot_grads
        out, gx, gy = grads(operand, *starts, keeps_bf16_maps())
        ctx.save_for_backward(gx, gy, u, v)
        ctx.shape = operand.shape
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        gx, gy, u, v = ctx.saved_tensors
        B, H, W, _ = ctx.shape
        g = g.contiguous()
        # bfloat16 maps widen before the contraction,
        # as the JAX backward casts them (geometry/warp.py:455-457 there)
        gx, gy = gx.to(g.dtype), gy.to(g.dtype)
        uf = u.reshape(B, -1)
        vf = v.reshape(B, -1)
        g_u = torch.where((uf >= 0) & (uf <= W - 1), (g * gx).sum(1), 0.0)
        g_v = torch.where((vf >= 0) & (vf <= H - 1), (g * gy).sum(1), 0.0)
        d_op = None
        if ctx.needs_input_grad[0]:
            splat = splat_twohot_ref if ctx.plain else splat_twohot
            d_op = splat(g, *_corner_weights(ctx.shape, u, v), H, W)
        return d_op, g_u.reshape(u.shape), g_v.reshape(v.shape), None


def _bilinear_gather_tiny(operand, u, v):
    """Bilinear sample of a plane under 2x2 ``[B,H,W,C]`` at (u, v) ->
    ``[B,C,N]`` in tensor ops (differentiable by autograd): the far corner
    clamps to the last row or column, as in the JAX package."""
    B, H, W, C = operand.shape

    def clip(x, hi):  # max then min, as jnp.clip: a tie splits its gradient
        return torch.minimum(torch.maximum(x.reshape(B, -1), x.new_tensor(0.0)),
                             x.new_tensor(hi))

    uf, vf = clip(u, W - 1.0), clip(v, H - 1.0)
    u0, v0 = torch.floor(uf), torch.floor(vf)
    du, dv = (uf - u0)[:, None], (vf - v0)[:, None]
    # a NaN coordinate samples NaN, from any cell
    u0i, v0i = u0.nan_to_num().long(), v0.nan_to_num().long()
    u1i, v1i = (u0i + 1).clamp(max=W - 1), (v0i + 1).clamp(max=H - 1)
    flat = operand.reshape(B, H * W, C).transpose(1, 2)  # [B,C,HW]

    def g(vi, ui):
        return torch.gather(flat, 2, (vi * W + ui)[:, None, :].expand(B, C, -1))

    return (g(v0i, u0i) * (1 - du) * (1 - dv) + g(v0i, u1i) * du * (1 - dv)
            + g(v1i, u0i) * (1 - du) * dv + g(v1i, u1i) * du * dv)


def warp_operand(operand, sizes, u, v, plain: bool = False):
    """Sample a prebuilt channels-last operand at (u, v) ``[B,1,h,w]``:
    through :class:`BilinearGather` (K2 or K5, and K3 in the backward) when
    autograd records the operand or the coordinates, else through K1, or K4
    where :func:`use_tiles` holds; a plane under 2x2 through
    :func:`_bilinear_gather_tiny`.

    :return: list of per-map ``[B,Ci,h,w]``
    """
    B = operand.shape[0]
    if operand.shape[1] < 2 or operand.shape[2] < 2:
        out = _bilinear_gather_tiny(operand, u, v)
    elif torch.is_grad_enabled() and (operand.requires_grad or u.requires_grad
                                    or v.requires_grad):
        out = BilinearGather.apply(operand, u, v, plain)
    else:
        starts = _corner_weights(operand.shape, u, v)
        grid = _tiles_grid("eval", operand.shape, u)
        if grid is not None:
            sample = gather_tiles_ref if plain else gather_tiles
            starts = [t.reshape(B, *grid) for t in starts]
        else:
            sample = gather_twohot_ref if plain else gather_twohot
        out = sample(operand, *starts)  # [B,Ctot,N]
    out = out.reshape(B, -1, u.shape[2], u.shape[3])
    return list(torch.split(out, sizes, dim=1))


def warp_multi(maps, u, v, plain: bool = False):
    """Sample several ``[B,Ci,H,W]`` maps at (u, v) ``[B,1,h,w]`` in ONE
    gather of their stacked operand.

    :return: list of per-map ``[B,Ci,h,w]``
    """
    return warp_operand(*make_warp_operand(maps), u, v, plain=plain)


def warp_features(F, u, v, plain: bool = False):
    """Sample one map ``F [B,C,H,W]`` at (u, v) ``[B,1,h,w]`` -> ``[B,C,h,w]``."""
    return warp_multi([F], u, v, plain=plain)[0]


def grad_bilinear_interpolation(F, u, v):
    """Exact derivative of bilinear sampling of ``F [B,C,H,W]`` at (u, v)
    ``[B,1,h,w]``: within each cell, the x derivative is the v-blended
    difference of the right and left columns, and the y one likewise.

    :return: ``(gx, gy, invalid)``: ``[B,C,h,w]`` each, and ``[B,1,h,w]``
        True where (u, v) is not finite or not strictly inside
        ``(0, size-1)``
    """
    B, C, H, W = F.shape
    h, w = u.shape[2], u.shape[3]
    uf, vf = u.reshape(B, -1), v.reshape(B, -1)
    invalid = ~((uf > 0) & (vf > 0) & (uf < W - 1) & (vf < H - 1)
                & torch.isfinite(uf) & torch.isfinite(vf))
    uc, vc = uf.clamp(0.0, W - 1.0), vf.clamp(0.0, H - 1.0)
    u0, v0 = torch.floor(uc), torch.floor(vc)
    du, dv = (uc - u0)[:, None], (vc - v0)[:, None]
    # a NaN coordinate samples NaN, from any cell
    u0i, v0i = u0.nan_to_num().long(), v0.nan_to_num().long()
    u1i, v1i = (u0i + 1).clamp(max=W - 1), (v0i + 1).clamp(max=H - 1)
    flat = F.reshape(B, C, H * W)

    def g(vi, ui):
        return torch.gather(flat, 2, (vi * W + ui)[:, None, :].expand(B, C, -1))

    f00, f01, f10, f11 = g(v0i, u0i), g(v0i, u1i), g(v1i, u0i), g(v1i, u1i)
    gx = (f01 - f00) * (1 - dv) + (f11 - f10) * dv
    gy = (f10 - f00) * (1 - du) + (f11 - f01) * du
    return gx.reshape(B, C, h, w), gy.reshape(B, C, h, w), invalid.reshape(B, 1, h, w)


def compute_vertex(depth, px, py):
    """Depth map ``[B,1,H,W]`` -> vertex map ``[px*d, py*d, d]`` ``[B,3,H,W]``."""
    return torch.cat([px * depth, py * depth, depth], dim=1)


def transform_xyz_jacobian(xyz, R):
    """Jacobian of ``R p + t`` in the ``[rot, trs]`` twist of the
    uncertainty-propagating EPE loss: ``[skew(R p) | -I]``.

    :param xyz: point-cloud map ``[B,3,H,W]``
    :return: ``[B,H*W,3,6]``
    """
    from .lie import skew

    B, _, H, W = xyz.shape
    rotated = (R @ xyz.reshape(B, 3, H * W)).transpose(1, 2)  # [B,HW,3]
    J_t = -torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(B, H * W, 3, 3)
    return torch.cat([skew(rotated), J_t], dim=-1)


def batch_project(xyz, K):
    """Project a point-cloud map ``[B,3,H,W]`` to pixel coordinates
    ``[u, v]`` ``[B,2,H,W]``."""
    x, y, z = xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]
    fx, fy, cx, cy = (K[:, i, None, None, None] for i in range(4))
    return torch.cat([fx * x / z + cx, fy * y / z + cy], dim=1)


def scale_K(K: torch.Tensor, level: int) -> torch.Tensor:
    """Intrinsics for pyramid level ``level`` (K / 2^level)."""
    return K / float(1 << level)


def resize_K(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Intrinsics for an image resized by (sx, sy)."""
    return K * torch.tensor([sx, sy, sx, sy], dtype=K.dtype, device=K.device)[None, :]


def batch_inverse_project(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth map ``[B,1,H,W]`` (or ``[B,H,W]``) -> point-cloud map
    ``[px*d, py*d, d]`` ``[B,3,H,W]``."""
    if depth.ndim == 3:
        depth = depth[:, None]
    B, _, H, W = depth.shape
    px, py = generate_xy_grid(B, H, W, K)
    return torch.cat([px * depth, py * depth, depth], dim=1)


def batch_transform_xyz(xyz: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rigid transform ``R p + t`` of a point-cloud map ``[B,3,H,W]``."""
    B, _, H, W = xyz.shape
    out = R @ xyz.reshape(B, 3, H * W) + t.reshape(B, 3, 1)
    return out.reshape(B, 3, H, W)


def batch_warp_affine(pu, pv, affine):
    """2D affine warp of a pixel grid ``[B,1,H,W]`` each by ``affine``
    ``[B,2,3]`` (or ``[B,3,3]``, whose last row is ignored)."""
    B, _, H, W = pu.shape
    uv1 = torch.cat([pu, pv, torch.ones_like(pu)], dim=1).reshape(B, 3, H * W)
    out = affine[:, :2, :] @ uv1
    return out[:, 0].reshape(B, 1, H, W), out[:, 1].reshape(B, 1, H, W)
