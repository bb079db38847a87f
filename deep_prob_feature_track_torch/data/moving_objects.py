"""MovingObjects3D: the synthetic object-motion dataset (object-centric poses).

Counterpart of ``deep_prob_feature_track_tpu/data/moving_objects.py``, on
numpy and the standard library: each sequence's ``info.pkl`` (poses, object
masks, visible frames), the object-centric relative transform
``inv(cam1) @ obj1 @ inv(obj0) @ cam0`` in float64, binary object masks
(``png == 1``), depth ``png / 1000`` clipped to [0.1, 100] m.  Train
categories aeroplane/bicycle/bus/car (sequences 0-190), validation 190-200,
test boat/motorbike.

``info.pkl`` is a pickle, and unpickling can run arbitrary code: load only
dataset files from a trusted source, as with the JAX loader.

The JAX loader decodes colour through its native tier (the port's
:func:`.io.read_rgb` copies it) but depth and masks through PIL: the port
reads their PNG files with :mod:`.png` (8-bit palette masks too) and
resizes them with :func:`.io.resize_nearest_pil`, PIL's nearest rule, to
the same pixels; depth is ``float32(value) / 1000`` (a division, not the TUM
path's product with ``1 / depth_scale``).
"""

from __future__ import annotations

import functools
import os
import pickle
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from .io import hwc_to_chw, read_rgb, resize_nearest_pil
from .png import read_png

CATEGORIES = {
    "train": {"aeroplane": (0, 190), "bicycle": (0, 190), "bus": (0, 190), "car": (0, 190)},
    "validation": {
        "aeroplane": (190, 200),
        "bicycle": (190, 200),
        "bus": (190, 200),
        "car": (190, 200),
    },
    "test": {"boat": (0, 200), "motorbike": (0, 200)},
}


def extract_info_pickle(info_pkl: str):
    """A sequence's ``info.pkl`` (a trusted file): colour, depth and mask
    paths relative to the dataset root, camera poses, the object's poses
    and visible frames, and the intrinsics."""
    with open(info_pkl, "rb") as p:
        info = pickle.load(p)

    def rel(xs):
        return [x.split("final/")[1] for x in xs]

    return (
        rel(info["color"]),
        rel(info["depth"]),
        rel(info["object_mask"]),
        info["pose"],
        info["object_poses"]["Model_1"],
        info["object_visible_frames"]["Model_1"],
        info["calib"],
    )


class MovingObjects3D:
    """Two-view items of the visible frames of each sequence.

    Validation and test take one keyframe gap, which becomes the stride of
    the visible frames (each item pairs a frame with the next); training
    draws each item's gap from ``keyframes`` with the global
    ``random.choice`` in ``__getitem__``, so a loader's one prefetch thread
    draws them in index order.
    """

    def __init__(
        self,
        root: str,
        category: str = "train",
        keyframes: Sequence[int] = (1,),
        select_traj: Optional[str] = None,
        image_resize: float = 0.5,
        augment=None,
    ):
        self.base = root
        self.augment = augment
        self.fx_s = self.fy_s = image_resize

        if category in ("validation", "test"):
            if len(keyframes) != 1:
                raise ValueError(f"the {category} split takes one keyframe gap, got {keyframes}")
            self.keyframes = [1]
            sample_freq = keyframes[0]
        else:
            self.keyframes = list(keyframes)
            sample_freq = 1

        self.image_seq: List[List[str]] = []
        self.depth_seq: List[List[str]] = []
        self.mask_seq: List[List[str]] = []
        self.cam_pose_seq = []
        self.obj_pose_seq = []
        self.obj_vis_idx = []
        self.calib = []
        self.obj_names = []
        self.ids = 0
        self.seq_acc_ids = [0]

        for obj, (start, end) in CATEGORIES[category].items():
            if select_traj is not None and obj != select_traj:
                continue
            for seq_idx in range(start, end):
                info_pkl = os.path.join(root, obj, f"{seq_idx:06d}", "info.pkl")
                colors, depths, masks, cam_poses, obj_poses, visible, calib = (
                    extract_info_pickle(info_pkl))
                visible = visible[::sample_freq]
                self.image_seq.append([os.path.join(root, x) for x in colors])
                self.depth_seq.append([os.path.join(root, x) for x in depths])
                self.mask_seq.append([os.path.join(root, x) for x in masks])
                self.cam_pose_seq.append(cam_poses)
                self.obj_pose_seq.append(obj_poses)
                self.calib.append(calib)
                self.obj_vis_idx.append(visible)
                self.obj_names.append(f"{obj}_{seq_idx:03d}")
                self.ids += max(0, len(visible) - max(self.keyframes))
                self.seq_acc_ids.append(self.ids)

    def __len__(self):
        return self.ids

    def _read_gray(self, path: str) -> np.ndarray:
        """One-channel PNG samples [H,W] (palette indices of a palette
        file), resized by the dataset's scale with PIL's nearest rule."""
        img = read_png(path)
        if img.shape[2] != 1:
            raise ValueError(f"{path}: a depth or mask PNG has one channel, this one has "
                             f"{img.shape[2]}")
        img = img[..., 0]
        if self.fx_s != 1.0:
            H, W = img.shape
            img = resize_nearest_pil(img, int(round(H * self.fy_s)), int(round(W * self.fx_s)))
        return img

    def _read_depth(self, path: str) -> np.ndarray:
        depth = self._read_gray(path).astype(np.float32) / np.float32(1e3)
        return np.clip(depth, np.float32(1e-1), np.float32(1e2))[None]

    def _read_mask(self, path: str, seg_index: int = 1) -> np.ndarray:
        return (self._read_gray(path) == seg_index)[None]

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        seq_idx = max(np.searchsorted(self.seq_acc_ids, index + 1) - 1, 0)
        frame_idx = index - self.seq_acc_ids[seq_idx]
        vis = self.obj_vis_idx[seq_idx]
        this_idx = vis[frame_idx]
        next_idx = vis[frame_idx + random.choice(self.keyframes)]

        color0 = read_rgb(self.image_seq[seq_idx][this_idx], self.fx_s)
        color1 = read_rgb(self.image_seq[seq_idx][next_idx], self.fx_s)
        if self.augment is not None:
            color0, color1 = self.augment([color0, color1])
        depth0 = self._read_depth(self.depth_seq[seq_idx][this_idx])
        depth1 = self._read_depth(self.depth_seq[seq_idx][next_idx])
        mask0 = self._read_mask(self.mask_seq[seq_idx][this_idx])
        mask1 = self._read_mask(self.mask_seq[seq_idx][next_idx])

        cam0 = self.cam_pose_seq[seq_idx][this_idx]
        cam1 = self.cam_pose_seq[seq_idx][next_idx]
        obj0 = self.obj_pose_seq[seq_idx][this_idx]
        obj1 = self.obj_pose_seq[seq_idx][next_idx]
        transform = functools.reduce(
            np.dot, [np.linalg.inv(cam1), obj1, np.linalg.inv(obj0), cam0]
        ).astype(np.float32)

        # the float32 intrinsics scaled in a float64 product, then cast
        calib = np.asarray(self.calib[seq_idx], dtype=np.float32)
        calib = calib * np.asarray([self.fx_s, self.fy_s, self.fx_s, self.fy_s])
        return {
            "color0": hwc_to_chw(color0),
            "color1": hwc_to_chw(color1),
            "depth0": depth0.astype(np.float32),
            "depth1": depth1.astype(np.float32),
            "transform": transform,
            "calib": calib.astype(np.float32),
            "obj_mask0": mask0,
            "obj_mask1": mask1,
            "name": {
                "seq": self.obj_names[seq_idx],
                "frame0": int(this_idx),
                "frame1": int(next_idx),
            },
        }
