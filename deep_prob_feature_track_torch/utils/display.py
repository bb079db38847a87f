"""Visualization helpers: mosaics, feature-channel grids, flow colouring,
match dots, and PNG output.

Counterpart of ``deep_prob_feature_track_tpu/utils/display.py``, on numpy
alone: every function returns a float image [H,W,3] in [0, 1], and
:func:`save_image` writes it through the port's own PNG writer
(``data/png.py``), since the card's machine has no PIL.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..data.png import write_png


def normalize01(x: np.ndarray) -> np.ndarray:
    """``x`` scaled to [0, 1] by its min and max (zeros where flat), float32."""
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.zeros_like(x, dtype=np.float32)
    return ((x - lo) / (hi - lo)).astype(np.float32)


def colormap_jet(x: np.ndarray) -> np.ndarray:
    """[H,W] in [0,1] -> [H,W,3] jet-like colour map."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def image_to_display(img: np.ndarray, cmap: Optional[str] = None) -> np.ndarray:
    """CHW or HW(C) array -> displayable [H,W,3] float image in [0,1]: one
    channel normalized to [0, 1] (in gray, or through :func:`colormap_jet`
    with ``cmap="jet"``), three clipped to [0, 1]."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[0] < img.shape[-1]:
        img = np.transpose(img, (1, 2, 0))
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        x = normalize01(img[..., 0])
        return colormap_jet(x) if cmap == "jet" else np.repeat(x[..., None], 3, -1)
    return np.clip(img[..., :3], 0.0, 1.0).astype(np.float32)


def create_mosaic(
    images: Sequence[np.ndarray],
    cmap: Optional[Sequence[Optional[str]]] = None,
    rows: Optional[int] = None,
) -> np.ndarray:
    """The images (each through :func:`image_to_display`, with its
    ``cmap``) on a grid of ``rows`` rows (floor(sqrt(n)) by default), row
    by row, in cells of the largest height and width."""
    n = len(images)
    if rows is None:
        rows = int(math.floor(math.sqrt(n)))
    cols = int(math.ceil(n / rows))
    disp = [image_to_display(im, cmap[i] if cmap else None) for i, im in enumerate(images)]
    H = max(d.shape[0] for d in disp)
    W = max(d.shape[1] for d in disp)
    canvas = np.zeros((rows * H, cols * W, 3), np.float32)
    for i, d in enumerate(disp):
        r, c = divmod(i, cols)
        canvas[r * H: r * H + d.shape[0], c * W: c * W + d.shape[1]] = d
    return canvas


def visualize_feature_channels(
    feat: np.ndarray, rgb: Optional[np.ndarray] = None, add_avg: bool = True
) -> np.ndarray:
    """Mosaic of a [C,H,W] (or [B,C,H,W], first item) feature map: the RGB
    image where given, the channel mean, then each channel, in jet."""
    feat = np.asarray(feat)
    if feat.ndim == 4:
        feat = feat[0]
    panels: List[np.ndarray] = []
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.ndim == 4:
            rgb = rgb[0]
        panels.append(image_to_display(rgb))
    if add_avg:
        panels.append(image_to_display(feat.mean(axis=0), cmap="jet"))
    for c in range(feat.shape[0]):
        panels.append(image_to_display(feat[c], cmap="jet"))
    return create_mosaic(panels)


def flow_to_color(flow: np.ndarray) -> np.ndarray:
    """[2,H,W] flow -> colour-wheel image [H,W,3]: hue from the direction,
    value from the normalized magnitude."""
    fx, fy = flow[0], flow[1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)  # [0,1]
    val = normalize01(mag)
    h6 = ang * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = np.zeros_like(val)
    q = val * (1 - f)
    t = val * f
    lut = [
        (val, t, p), (q, val, p), (p, val, t),
        (p, q, val), (t, p, val), (val, p, q),
    ]
    r = np.choose(i, [entry[0] for entry in lut])
    g = np.choose(i, [entry[1] for entry in lut])
    b = np.choose(i, [entry[2] for entry in lut])
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def visualize_matches_on_image(
    image: np.ndarray,
    matches: np.ndarray,
    radius: Optional[int] = None,
    color=(1.0, 0.0, 0.0),
    alpha: float = 0.6,
) -> np.ndarray:
    """Match dots on an image: a filled disk of ``color`` at every match
    coordinate inside the image, blended ``alpha * marked + (1 - alpha) *
    image``; the radius defaults to W/64 (10 pixels at 640 wide).

    :param image: [H,W,3]/[3,H,W]/[H,W] image (normalized as in
        :func:`image_to_display`)
    :param matches: [2, N] pixel coordinates, row 0 = u (x), row 1 = v (y)
    :return: [H,W,3] float image in [0,1]
    """
    img = image_to_display(np.asarray(image))
    H, W = img.shape[:2]
    if radius is None:
        radius = max(int(W / 64), 1)
    m = np.rint(np.asarray(matches, np.float64)).astype(int)
    marked = img.copy()
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    disk = (xx * xx + yy * yy) <= radius * radius
    col = np.asarray(color, np.float32)
    for i in range(m.shape[1]):
        u, v = int(m[0, i]), int(m[1, i])
        if not (0 <= u < W and 0 <= v < H):
            continue
        y0, y1 = max(v - radius, 0), min(v + radius + 1, H)
        x0, x1 = max(u - radius, 0), min(u + radius + 1, W)
        sub = disk[y0 - (v - radius): y1 - (v - radius), x0 - (u - radius): x1 - (u - radius)]
        marked[y0:y1, x0:x1][sub] = col
    return (alpha * marked + (1.0 - alpha) * img).astype(np.float32)


def visualize_frames(
    mat: np.ndarray,
    max_img: Optional[int] = None,
    max_channel: Optional[int] = None,
    step_image: int = 1,
    step_channel: int = 1,
) -> np.ndarray:
    """Batch x channel grid of a [B,C,H,W] array: one mosaic row per
    (strided) item, one jet panel per (strided) channel."""
    mat = np.asarray(mat)
    B = mat.shape[0] if max_img is None else min(max_img, mat.shape[0])
    C = mat.shape[1] if max_channel is None else min(max_channel, mat.shape[1])
    panels: List[np.ndarray] = []
    rows = 0
    for i in range(0, B, step_image):
        rows += 1
        for j in range(0, C, step_channel):
            panels.append(mat[i, j])
    return create_mosaic(panels, cmap=["jet"] * len(panels), rows=max(rows, 1))


def save_image(path: str, img: np.ndarray) -> None:
    """Write a float image [H,W,3] in [0, 1] as an 8-bit PNG: clipped,
    scaled by 255 and truncated to ``uint8``."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
