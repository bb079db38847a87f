"""Host-side image reading and resizing (numpy in and out).

Counterpart of ``deep_prob_feature_track_tpu/data/io.py``.  The JAX package
decodes through its native tier (``native/dpft_io.cpp``) wherever that
library loads, and through OpenCV or PIL elsewhere; the port decodes PNG
files with :mod:`.png` and copies the native tier's arithmetic, in float32
and in the same order, so that both give the same bits.  The port's own
native tier (:mod:`.native_io`, C++) runs every decode and resize here;
``plain=True`` takes the numpy twins, which give the same bits:

- colour: libpng's 16-to-8-bit strip, gray expanded to RGB and alpha
  dropped; a bilinear resize with half-pixel centres that blends the
  ``uint8`` values and scales by ``1/255`` after (``dpft_decode_rgb``);
- depth: nearest sampling at ``floor(dst * H / out_h)``, then ``1 /
  depth_scale``, then the clip (``dpft_decode_depth16``).

The output size is ``round(H * scale)`` with the scale in float32.

JPEG colour frames (ScanNet's) take the JAX package's OpenCV branch:
:mod:`.jpeg` decodes them to the bits of ``cv2.imread``, then BGR becomes
RGB, ``astype(float32) / 255`` (a division, where the PNG path multiplies
by ``1/255`` after the blend), and ``cv2.resize(img, None, fx=s, fy=s)``
with ``INTER_LINEAR`` on float32 (:func:`resize_linear_cv`).

The JAX package's MovingObjects3D loader reads depth and masks through PIL
instead; :func:`resize_nearest_pil` copies PIL's nearest resize for it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from . import native_io
from .jpeg import read_jpeg
from .png import read_png

_F = np.float32


def _out_size(n: int, scale: float) -> int:
    return int(math.floor(float(_F(n) * _F(scale)) + 0.5))


def read_rgb(path: str, scale: float = 1.0, plain: bool = False) -> np.ndarray:
    """Read an RGB PNG or JPEG -> float32 [H,W,3] in [0,1], resized by
    ``scale``; ``plain`` decodes and resizes in numpy."""
    if path.lower().endswith((".jpg", ".jpeg")):
        img = read_jpeg(path, plain=plain).astype(_F) / _F(255)
        return img if scale == 1.0 else resize_linear_cv(img, scale, plain=plain)
    img = read_png(path, plain=plain)
    if not plain:
        H, W = img.shape[:2]
        return native_io.png_rgb(img, _out_size(H, scale), _out_size(W, scale))
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


def resize_linear_cv(img: np.ndarray, scale: float, plain: bool = False) -> np.ndarray:
    """``cv2.resize(img, None, fx=scale, fy=scale)`` (``INTER_LINEAR``) of a
    float32 [H,W,C] image, bit for bit as OpenCV 5 computes it through its
    bundled Intel IPP on an x86-64 host with FMA, for ``scale < 1`` (at 1
    OpenCV copies the image, where this blends the last row and column with
    weight 1); the native tier computes each blend with ``std::fmaf``,
    ``plain`` in numpy.

    The output size is ``cvRound(n * scale)`` (ties to even).  Each output
    sample sits at ``(i + 0.5) / scale - 0.5`` (float64), clamped to ``[0,
    n - 1]``; its left neighbour ``x0 = min(floor(x), n - 2)`` and its
    weight ``float32(x - x0)``, so the last sample blends with weight 1.
    Rows are resized first, then columns, each as one fused multiply-add
    ``p0 + (p1 - p0) * w`` rounded once to float32 (computed here in
    ``longdouble``).  OpenCV's own, non-IPP code gives other bits
    (separate products, float32 weights).
    """
    H, W = img.shape[:2]
    out_h, out_w = int(np.rint(H * scale)), int(np.rint(W * scale))
    if not plain:
        return native_io.resize_linear_cv(img, scale, out_h, out_w)
    wide = np.longdouble

    def axis(n_in, n_out):
        x = np.clip((np.arange(n_out) + 0.5) / scale - 0.5, 0.0, n_in - 1)
        x0 = np.minimum(np.floor(x).astype(np.int64), max(n_in - 2, 0))
        return x0, np.minimum(x0 + 1, n_in - 1), (x - x0).astype(_F)

    def lerp(p0, p1, w):
        return ((p1 - p0).astype(wide) * w + p0).astype(_F)

    y0, y1, wy = axis(H, out_h)
    x0, x1, wx = axis(W, out_w)
    rows = lerp(img[:, x0], img[:, x1], wx[None, :, None])
    return lerp(rows[y0], rows[y1], wy[:, None, None])


def read_depth_png(
    path: str,
    depth_scale: float = 5000.0,
    scale: float = 1.0,
    clip: Optional[Tuple[float, float]] = (0.5, 5.0),
    plain: bool = False,
) -> np.ndarray:
    """Read a one-channel (16-bit) depth PNG -> float32 [1,H,W] in meters.

    TUM convention: value/depth_scale = meters; nearest-neighbour resize
    (depth must not blend across boundaries); the clip to [0.5, 5.0] m
    (Kinect range) unless ``clip`` is None.  ``plain`` decodes and samples
    in numpy.
    """
    img = read_png(path, plain=plain)
    if img.shape[2] != 1:
        raise ValueError(f"{path}: a depth PNG has one channel, this one has {img.shape[2]}")
    H, W = img.shape[:2]
    out_h, out_w = _out_size(H, scale), _out_size(W, scale)
    if not plain:
        return native_io.png_depth(img, out_h, out_w, depth_scale, clip)[None]
    ys = np.minimum((np.arange(out_h).astype(_F) * (_F(H) / _F(out_h))).astype(np.int64), H - 1)
    xs = np.minimum((np.arange(out_w).astype(_F) * (_F(W) / _F(out_w))).astype(np.int64), W - 1)
    depth = img[ys][:, xs, 0].astype(_F) * (_F(1) / _F(depth_scale))
    cmin, cmax = clip if clip is not None else (0.0, -1.0)
    if cmax > 0:
        depth = np.clip(depth, _F(cmin), _F(cmax))
    return depth[None]


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(img, (2, 0, 1)))


def _pil_nearest_index(n_in: int, n_out: int, accumulate: bool) -> np.ndarray:
    """The source index of each of ``n_out`` samples in PIL's nearest
    resize: ``floor((i + 0.5) * n_in / n_out)`` in float64, taken as PIL
    takes it: for 8-bit images by adding the step to the running
    coordinate, sample after sample (``ImagingScaleAffine``), for 16-bit
    ones at each sample directly (``ImagingGenericTransform``).  The two
    differ in the last bit where the step is not exact (odd sizes)."""
    step = n_in / n_out
    if accumulate:
        x = np.full(n_out, step)
        x[0] = step * 0.5
        x = np.add.accumulate(x)
    else:
        x = (np.arange(n_out) + 0.5) * step
    return np.minimum(x.astype(np.int64), n_in - 1)


def resize_nearest_pil(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL's ``Image.resize((out_w, out_h), Image.NEAREST)`` of an 8- or
    16-bit image [H,W] or [H,W,C], which samples at pixel centres (the
    native tier of :func:`read_depth_png` samples at ``floor(dst * H /
    out_h)``, which picks other pixels at 0.25)."""
    H, W = img.shape[:2]
    if (out_h, out_w) == (H, W):
        return img
    accumulate = img.dtype == np.uint8
    return img[_pil_nearest_index(H, out_h, accumulate)][:, _pil_nearest_index(W, out_w,
                                                                                accumulate)]
