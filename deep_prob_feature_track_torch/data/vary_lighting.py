"""Varying-lighting TUM-format sequences, without ground-truth poses.

Counterpart of ``deep_prob_feature_track_tpu/data/vary_lighting.py``: the
scenes are the folders of the root, each with ``rgb/*.png`` and the depth
at the same file name under ``depth/``; test and keyframe categories only;
depth read as TUM's (1/5000, the [0.5, 5] m clip); the intrinsics
``VL_CALIB`` scaled with the image; an item has no ``transform``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .io import hwc_to_chw, read_depth_png, read_rgb

VL_CALIB = [525.0, 525.0, 319.5, 239.5]


def depth_for_rgb(rgb_path: str) -> str:
    d, f = os.path.split(rgb_path)
    return os.path.join(d.replace("rgb", "depth"), f)


class VaryLighting:
    def __init__(
        self,
        root: str = "",
        category: str = "test",
        keyframes: Sequence[int] = (1,),
        select_traj: Optional[str] = None,
        image_resize: float = 0.25,
        truncate_depth: bool = True,
    ):
        assert category in ("test", "kf", "keyframe")
        self.fx_s = self.fy_s = image_resize
        self.truncate_depth = truncate_depth
        self.image_seq: List[List[str]] = []
        self.seq_names: List[str] = []
        self.ids = 0
        self.seq_acc_ids = [0]

        assert len(keyframes) == 1
        kf = keyframes[0] if category == "test" else 1
        for scene in sorted(glob.glob(os.path.join(root, "*/"))):
            scene_name = os.path.basename(os.path.dirname(scene))
            if select_traj is not None and scene_name != select_traj:
                continue
            rgbs = sorted(glob.glob(os.path.join(scene, "rgb", "*.png")))[::kf]
            if not rgbs:
                continue
            self.image_seq.append(rgbs)
            self.seq_names.append(scene_name)
            self.ids += max(0, len(rgbs) - 1)
            self.seq_acc_ids.append(self.ids)

    def __len__(self):
        return self.ids

    def _load(self, rgb_path: str):
        color = read_rgb(rgb_path, self.fx_s)
        clip = (0.5, 5.0) if self.truncate_depth else None
        # 1/5000 as TUM: the original loader divides by 5e3 where it reads
        # (its class attribute DEPTH_SCALE = 1/1000 is unused)
        depth = read_depth_png(depth_for_rgb(rgb_path), 5000.0, self.fx_s, clip)
        return color, depth

    def _pair(self, seq_idx, idx0, idx1) -> Dict[str, np.ndarray]:
        c0, d0 = self._load(self.image_seq[seq_idx][idx0])
        c1, d1 = self._load(self.image_seq[seq_idx][idx1])
        calib = np.asarray(VL_CALIB, dtype=np.float32) * np.asarray(
            [self.fx_s, self.fy_s, self.fx_s, self.fy_s])
        return {
            "color0": hwc_to_chw(c0),
            "color1": hwc_to_chw(c1),
            "depth0": d0.astype(np.float32),
            "depth1": d1.astype(np.float32),
            "calib": calib.astype(np.float32),
            "name": {"seq": self.seq_names[seq_idx], "frame0": idx0, "frame1": idx1},
        }

    def _locate(self, index):
        seq_idx = max(np.searchsorted(self.seq_acc_ids, index + 1) - 1, 0)
        return seq_idx, index - self.seq_acc_ids[seq_idx]

    def __getitem__(self, index):
        seq_idx, frame_idx = self._locate(index)
        return self._pair(seq_idx, frame_idx, frame_idx + 1)

    def get_keypair(self, index, kf_idx: int = 0):
        seq_idx, frame_idx = self._locate(index)
        return self._pair(seq_idx, kf_idx, frame_idx)

    def pair_frames(self, idx0: int, idx1: int, seq_idx: int = 0):
        """Direct frame-pair access by raw frame indices (VO / BA front ends)."""
        return self._pair(seq_idx, idx0, idx1)

    def num_frames(self, seq_idx: int = 0) -> int:
        return len(self.image_seq[seq_idx])
