"""ScanNet RGB-D scans (train / validation / test).

Counterpart of ``deep_prob_feature_track_tpu/data/scannet.py``, on the
port's decoders: per-scan frame listings from ``_info.txt`` and per-frame
``.pose.txt`` files, frames with an infinite pose (tracking failures)
dropped and the list cached to ``sync_trajectory.pkl`` (a pickle of plain
dicts and numpy arrays, which either package reads when the other wrote
it), the ``subset_train``/``subset_val`` split of each scan, the stride-kf
test sampling, and the keyframe-gap repair: where the drawn gap spans
dropped frames, the nearest gap within range is searched for (drawing
from the global ``random`` in ``__getitem__``, in item order, as ``TUM``
does).

Layout: ``<root>/{train,val}/<scan>/_info.txt`` (its last line ends with
the frame count) and ``frame-XXXXXX.{color.jpg,merged_depth.png,pose.txt}``.
Colour frames are JPEG files, decoded by :mod:`.jpeg` to the bits of the
JAX package's OpenCV; depth is 16-bit PNG at 5000 units a metre.
``SCANNET_CAM`` (fx 577.871, centre 319.5, 239.5) is the 640x480 depth
camera's, and colour and depth are scaled by one factor, so a scan's
colour frames must be 640x480 (ScanNet's exported colour is 1296x968 and
must be resized to the depth size first), as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from .io import hwc_to_chw, read_depth_png, read_rgb

SCANNET_CAM = {"fx": 577.871, "fy": 577.871, "ux": 319.5, "uy": 239.5}


def read_scan(seq_dir: str):
    """Load (building if needed) a scan's synchronized view list."""
    sync = os.path.join(seq_dir, "sync_trajectory.pkl")
    if os.path.isfile(sync):
        with open(sync, "rb") as f:
            return pickle.load(f)
    info = os.path.join(seq_dir, "_info.txt")
    nframes = int(open(info).readlines()[-1].split()[-1])
    views = []
    for i in range(nframes):
        frame = os.path.join(seq_dir, f"frame-{i:06d}")
        pose = np.loadtxt(frame + ".pose.txt")
        if np.isinf(np.sum(pose)):  # drop tracking-failure frames
            continue
        views.append(
            {
                "img": frame + ".color.jpg",
                "dpt": frame + ".merged_depth.png",
                "frame_id": i,
                "pose": pose,
            }
        )
    with open(sync, "wb") as f:
        pickle.dump(views, f)
    return views


class ScanNet:
    def __init__(
        self,
        root: str,
        category: str = "train",
        keyframes: Sequence[int] = (1,),
        select_traj: Optional[str] = None,
        image_resize: float = 0.25,
        truncate_depth: bool = True,
        subset_train: float = 0.95,
        subset_val: float = 0.05,
        augment=None,
    ):
        self.fx_s = self.fy_s = image_resize
        self.truncate_depth = truncate_depth
        self.augment = augment
        self.image_seq: List[List[str]] = []
        self.depth_seq: List[List[str]] = []
        self.frame_id_seq: List[List[int]] = []
        self.cam_pose_seq = []
        self.calib = []
        self.seq_names: List[str] = []
        self.ids = 0
        self.seq_acc_ids = [0]
        self.keyframes = list(keyframes)

        calib = [SCANNET_CAM["fx"], SCANNET_CAM["fy"], SCANNET_CAM["ux"], SCANNET_CAM["uy"]]

        if category == "test":
            assert len(self.keyframes) == 1
            kf = self.keyframes[0]
            self.keyframes = [1]
            data_dir = os.path.join(root, "val")
            for seq in sorted(os.listdir(data_dir)):
                seq_dir = os.path.join(data_dir, seq)
                if not os.path.isdir(seq_dir):
                    continue
                if select_traj is not None and seq != select_traj:
                    continue
                views = read_scan(seq_dir)[::kf]
                self._append(seq, views, calib, test=True)
            if not self.image_seq:
                raise FileNotFoundError("specified trajectory not in the test set")
        else:
            data_dir = os.path.join(root, "train")
            for seq in sorted(os.listdir(data_dir)):
                seq_dir = os.path.join(data_dir, seq)
                if not os.path.isdir(seq_dir):
                    continue
                views = read_scan(seq_dir)
                total = len(views)
                if category == "train":
                    views = views[: int(subset_train * total)]
                else:
                    views = views[int((1 - subset_val) * total) :]
                self._append(seq, views, calib, test=False)

    def _append(self, seq_name, views, calib, test: bool):
        if not views:
            return
        self.image_seq.append([v["img"] for v in views])
        self.depth_seq.append([v["dpt"] for v in views])
        self.frame_id_seq.append([v["frame_id"] for v in views])
        self.cam_pose_seq.append([v["pose"] for v in views])
        self.calib.append(calib)
        self.seq_names.append(seq_name)
        span = 1 if test else max(self.keyframes)
        self.ids += max(0, len(views) - span)
        self.seq_acc_ids.append(self.ids)

    def __len__(self):
        return self.ids

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        seq_idx = max(np.searchsorted(self.seq_acc_ids, index + 1) - 1, 0)
        frame_idx = index - self.seq_acc_ids[seq_idx]
        this_idx = frame_idx
        next_idx = frame_idx + random.choice(self.keyframes)

        # inf-pose gaps: if the chosen keyframe spans dropped frames, search
        # nearer/behind for a frame-id gap within range (ref ScanNet.py:193-205)
        ts = self.frame_id_seq[seq_idx]
        if ts[next_idx] - ts[this_idx] > max(self.keyframes):
            for kf in self.keyframes[::-1] + [-k for k in self.keyframes]:
                cand = frame_idx + kf
                if 0 <= cand < len(ts) and abs(ts[cand] - ts[this_idx]) <= max(
                    self.keyframes
                ):
                    next_idx = cand
                    break
            else:
                next_idx = frame_idx + 1

        color0 = read_rgb(self.image_seq[seq_idx][this_idx], self.fx_s)
        color1 = read_rgb(self.image_seq[seq_idx][next_idx], self.fx_s)
        if self.augment is not None:
            color0, color1 = self.augment([color0, color1])
        clip = (0.5, 5.0) if self.truncate_depth else None
        depth0 = read_depth_png(self.depth_seq[seq_idx][this_idx], 5000.0, self.fx_s, clip)
        depth1 = read_depth_png(self.depth_seq[seq_idx][next_idx], 5000.0, self.fx_s, clip)

        calib = np.asarray(self.calib[seq_idx], dtype=np.float32)
        calib = calib * np.asarray([self.fx_s, self.fy_s, self.fx_s, self.fy_s])
        pose0 = self.cam_pose_seq[seq_idx][this_idx]
        pose1 = self.cam_pose_seq[seq_idx][next_idx]
        transform = (np.linalg.inv(pose1) @ pose0).astype(np.float32)
        return {
            "color0": hwc_to_chw(color0),
            "color1": hwc_to_chw(color1),
            "depth0": depth0.astype(np.float32),
            "depth1": depth1.astype(np.float32),
            "transform": transform,
            "calib": calib.astype(np.float32),
            "name": {
                "seq": self.seq_names[seq_idx],
                "frame0": this_idx,
                "frame1": next_idx,
            },
        }
