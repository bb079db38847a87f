"""Image-space ops: Sobel gradients, pooling pyramids and the loss's
bilinear resize.

Counterpart of ``deep_prob_feature_track_tpu/ops/image.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

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
    """Multi-scale pyramid, each level pooled from ``x`` by 2^s."""
    fn = {"avg": avg_pool2, "max": max_pool2}[pool]
    return [fn(x, 1 << s) for s in scales]


def bilinear_resize(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear resize of ``[B,C,h,w]`` to ``[B,C,H,W]`` as the JAX
    package's ``jax.image.resize(method="linear")`` computes it: half-pixel
    centres (``align_corners=False``) and, when downsampling, a triangle
    filter widened by the scale factor (``antialias=True``)."""
    return F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False, antialias=True)
