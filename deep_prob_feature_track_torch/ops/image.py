"""Image-space ops: Sobel gradients, pooling pyramids, normal maps, the
loss's bilinear resize and the M-estimator's align-corners upsample.

Counterpart of ``deep_prob_feature_track_tpu/ops/image.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..parallel.mesh import extrema_mask

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel_gradients(img: torch.Tensor, normalize_gradient: bool = True):
    """Per-channel Sobel x/y gradients of ``[B,C,H,W]`` with replicate padding,
    optionally normalized to unit magnitude."""
    B, C, H, W = img.shape
    p = F.pad(img.reshape(B * C, 1, H, W), (1, 1, 1, 1), mode="replicate")
    k = torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=img.dtype, device=img.device)
    g = F.conv2d(p, k[:, None])  # [B*C, 2, H, W]
    gx = g[:, 0].reshape(B, C, H, W)
    gy = g[:, 1].reshape(B, C, H, W)
    if normalize_gradient:
        mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
        gx = gx / mag
        gy = gy / mag
    return gx, gy


def avg_pool2(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping average pool by ``factor`` on [B,C,H,W]."""
    return x if factor == 1 else F.avg_pool2d(x, factor)


def max_pool2(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping max pool by ``factor`` on [B,C,H,W]."""
    return x if factor == 1 else F.max_pool2d(x, factor)


def image_pyramid(
    x: torch.Tensor, scales: Sequence[int] = (0, 1, 2, 3), pool: str = "avg"
) -> List[torch.Tensor]:
    """Multi-scale pyramid, each level pooled from ``x`` by 2^s.  A bool
    map (an object mask) is pooled as float and cast back, so that a window
    holding any True pixel stays True."""
    fn = {"avg": avg_pool2, "max": max_pool2}[pool]
    if x.dtype == torch.bool:
        return [fn(x.float(), 1 << s).bool() for s in scales]
    return [fn(x, 1 << s) for s in scales]


def compute_normal(vertex_map: torch.Tensor) -> torch.Tensor:
    """Normal map ``[B,3,H,W]`` of a vertex map: the cross product of its
    unnormalized Sobel derivatives, L2-normalized, and zero where the depth
    (channel 2) equals its batch-global min or max (truncated depth)."""
    gx, gy = sobel_gradients(vertex_map, normalize_gradient=False)
    normal = torch.linalg.cross(gx, gy, dim=1)
    normal = normal / (torch.linalg.vector_norm(normal, dim=1, keepdim=True) + 1e-8)
    depth = vertex_map[:, 2:3]
    return normal.masked_fill(extrema_mask(depth), 0.0)


def bilinear_resize(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear resize of ``[B,C,h,w]`` to ``[B,C,H,W]`` as the JAX
    package's ``jax.image.resize(method="linear")`` computes it: half-pixel
    centres (``align_corners=False``) and, when downsampling, a triangle
    filter widened by the scale factor (``antialias=True``)."""
    return F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False, antialias=True)


def bilinear_resize_align(x: torch.Tensor, H: int, W: int, plain: bool = False) -> torch.Tensor:
    """Align-corners bilinear resize of ``[B,C,h,w]`` to ``[B,C,H,W]``
    through :func:`geometry.warp.warp_features`: kernel K1, or K2 and K3
    under autograd (``plain=True``: their plain versions).  Returns ``x``
    itself, launching nothing, when the size already matches."""
    from ..geometry.warp import warp_features

    B, _, h, w = x.shape
    if h == H and w == W:
        return x
    sy = (h - 1.0) / (H - 1.0) if H > 1 else 0.0
    sx = (w - 1.0) / (W - 1.0) if W > 1 else 0.0
    v = (torch.arange(H, dtype=x.dtype, device=x.device) * sy)[None, None, :, None]
    u = (torch.arange(W, dtype=x.dtype, device=x.device) * sx)[None, None, None, :]
    return warp_features(x, u.expand(B, 1, H, W), v.expand(B, 1, H, W), plain=plain)
