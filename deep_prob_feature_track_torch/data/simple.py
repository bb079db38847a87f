"""Folder-of-PNGs consecutive-pair loader (the ``run_example`` path).

Counterpart of ``deep_prob_feature_track_tpu/data/simple.py``: sorted
colour and depth folders paired (i, i+1), TUM depth scaling 1/5000 with the
[0.5, 5] m clip, the intrinsics scaled with the image.  PNG files only
(``data/png.py``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .io import hwc_to_chw, read_depth_png, read_rgb


class SimpleLoader:
    def __init__(self, color_dir: str, depth_dir: str, K, image_resize: float = 1.0):
        color_files = sorted(os.listdir(color_dir))
        depth_files = sorted(os.listdir(depth_dir))
        assert len(color_files) == len(depth_files), (
            "color/depth folders must hold synchronized files"
        )
        self.color = [os.path.join(color_dir, f) for f in color_files]
        self.depth = [os.path.join(depth_dir, f) for f in depth_files]
        self.K = np.asarray(K, dtype=np.float32)
        self.scale = image_resize

    def __len__(self):
        return len(self.color) - 1

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        c0 = read_rgb(self.color[index], self.scale)
        c1 = read_rgb(self.color[index + 1], self.scale)
        d0 = read_depth_png(self.depth[index], 5000.0, self.scale, (0.5, 5.0))
        d1 = read_depth_png(self.depth[index + 1], 5000.0, self.scale, (0.5, 5.0))
        calib = self.K * np.asarray([self.scale] * 4, dtype=np.float32)
        return {
            "color0": hwc_to_chw(c0),
            "color1": hwc_to_chw(c1),
            "depth0": d0.astype(np.float32),
            "depth1": d1.astype(np.float32),
            "calib": calib,
        }
