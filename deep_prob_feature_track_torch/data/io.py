"""Host-side image reading and resizing (numpy in and out).

Counterpart of ``deep_prob_feature_track_tpu/data/io.py``.  The JAX package
decodes through its native tier (``native/dpft_io.cpp``) wherever that
library loads, and through OpenCV or PIL elsewhere; the port decodes PNG
files with :mod:`.png` and copies the native tier's arithmetic, in float32
and in the same order, so that both give the same bits:

- colour: libpng's 16-to-8-bit strip, gray expanded to RGB and alpha
  dropped; a bilinear resize with half-pixel centres that blends the
  ``uint8`` values and scales by ``1/255`` after (``dpft_decode_rgb``);
- depth: nearest sampling at ``floor(dst * H / out_h)``, then ``1 /
  depth_scale``, then the clip (``dpft_decode_depth16``).

The output size is ``round(H * scale)`` with the scale in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .png import read_png

_F = np.float32


def _out_size(n: int, scale: float) -> int:
    return int(math.floor(float(_F(n) * _F(scale)) + 0.5))


def read_rgb(path: str, scale: float = 1.0) -> np.ndarray:
    """Read an RGB PNG -> float32 [H,W,3] in [0,1], resized by ``scale``."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[2] <= 2:  # gray, gray + alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    src = img[..., :3].astype(_F)
    H, W = src.shape[:2]
    out_h, out_w = _out_size(H, scale), _out_size(W, scale)

    def axis(n_in, n_out):
        f = (np.arange(n_out).astype(_F) + _F(0.5)) * (_F(n_in) / _F(n_out)) - _F(0.5)
        i0 = np.floor(f).astype(np.int64)
        w = f - i0.astype(_F)
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w

    y0, y1, wy = axis(H, out_h)
    x0, x1, wx = axis(W, out_w)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = _F(1)
    rows0, rows1 = src[y0], src[y1]
    v = (rows0[:, x0] * (one - wx) * (one - wy) + rows0[:, x1] * wx * (one - wy)
         + rows1[:, x0] * (one - wx) * wy + rows1[:, x1] * wx * wy)
    return v * (one / _F(255))


def read_depth_png(
    path: str,
    depth_scale: float = 5000.0,
    scale: float = 1.0,
    clip: Optional[Tuple[float, float]] = (0.5, 5.0),
) -> np.ndarray:
    """Read a one-channel (16-bit) depth PNG -> float32 [1,H,W] in meters.

    TUM convention: value/depth_scale = meters; nearest-neighbour resize
    (depth must not blend across boundaries); the clip to [0.5, 5.0] m
    (Kinect range) unless ``clip`` is None.
    """
    img = read_png(path)
    if img.shape[2] != 1:
        raise ValueError(f"{path}: a depth PNG has one channel, this one has {img.shape[2]}")
    H, W = img.shape[:2]
    out_h, out_w = _out_size(H, scale), _out_size(W, scale)
    ys = np.minimum((np.arange(out_h).astype(_F) * (_F(H) / _F(out_h))).astype(np.int64), H - 1)
    xs = np.minimum((np.arange(out_w).astype(_F) * (_F(W) / _F(out_w))).astype(np.int64), W - 1)
    depth = img[ys][:, xs, 0].astype(_F) * (_F(1) / _F(depth_scale))
    cmin, cmax = clip if clip is not None else (0.0, -1.0)
    if cmax > 0:
        depth = np.clip(depth, _F(cmin), _F(cmax))
    return depth[None]


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(img, (2, 0, 1)))
