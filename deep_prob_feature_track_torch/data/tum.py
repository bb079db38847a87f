"""TUM RGB-D two-view dataset (train / validation / test).

Counterpart of ``deep_prob_feature_track_tpu/data/tum.py``, on the port's
own association, decoding and split modules:

* train/val use every frame with a randomly chosen keyframe gap; 95/5 split
  along each trajectory (ref :233-235)
* test subsamples the trajectory at stride kf so consecutive items chain
  into a proper trajectory (ref :247-299)
* items are dicts of numpy arrays; the relative pose is
  ``inv(pose1) @ pose0`` (ref :398-400); the keyframe gap of a
  train/validation item is drawn with the global ``random.choice`` in
  ``__getitem__``, so a loader's prefetch thread draws them in index order
* ``get_keypair`` pairs frame i against a fixed keyframe for keyframe-VO
  (ref :334-373)
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from .association import load_sync_trajectory, tq_to_matrix4
from .io import hwc_to_chw, read_depth_png, read_rgb
from .tum_dicts import TUM_CALIB, TUM_TEST, TUM_TRAINVAL


class TUM:
    def __init__(
        self,
        root: str = "",
        category: str = "train",
        keyframes: Sequence[int] = (1,),
        select_traj: Optional[str] = None,
        image_resize: float = 0.25,
        truncate_depth: bool = True,
        augment=None,
    ):
        self.image_seq: List[List[str]] = []
        self.depth_seq: List[List[str]] = []
        self.cam_pose_seq: List[List[np.ndarray]] = []
        self.calib: List[List[float]] = []
        self.seq_names: List[str] = []
        self.ids = 0
        self.seq_acc_ids = [0]
        self.keyframes = list(keyframes)
        self.augment = augment
        self.fx_s = self.fy_s = image_resize
        self.truncate_depth = truncate_depth

        if category == "test":
            self._load_test(root, select_traj)
        elif category in ("train", "validation"):
            self._load_train_val(root, category, select_traj)
        else:
            raise ValueError(category)

    # ------------------------------------------------------------------
    def _load_train_val(self, root, category, select_traj):
        for ks, seqs in TUM_TRAINVAL.items():
            for seq_name in seqs:
                if select_traj is not None and seq_name != select_traj:
                    continue
                self.calib.append(TUM_CALIB)
                traj = load_sync_trajectory(os.path.join(root, seq_name))
                total = len(traj)
                if category == "train":
                    s, e = 0, int(0.95 * total)
                else:
                    s, e = int(0.95 * total), total
                self.image_seq.append([traj[i][1] for i in range(s, e)])
                self.depth_seq.append([traj[i][2] for i in range(s, e)])
                self.cam_pose_seq.append(
                    [tq_to_matrix4(traj[i][0]) for i in range(s, e)]
                )
                self.seq_names.append(seq_name)
                self.ids += max(0, (e - s) - max(self.keyframes))
                self.seq_acc_ids.append(self.ids)

    def _load_test(self, root, select_traj):
        assert len(self.keyframes) == 1, "test supports one keyframe at a time"
        kf = self.keyframes[0]
        self.keyframes = [1]
        found = False
        for ks, seqs in TUM_TEST.items():
            for seq_name in seqs:
                if select_traj is not None and seq_name != select_traj:
                    continue
                found = True
                self.calib.append(TUM_CALIB)
                traj = load_sync_trajectory(os.path.join(root, seq_name))
                idxs = list(range(0, len(traj), kf))
                self.image_seq.append([traj[i][1] for i in idxs])
                self.depth_seq.append([traj[i][2] for i in idxs])
                self.cam_pose_seq.append([tq_to_matrix4(traj[i][0]) for i in idxs])
                self.seq_names.append(seq_name)
                self.ids += max(0, len(idxs) - 1)
                self.seq_acc_ids.append(self.ids)
        if not found and select_traj is not None and os.path.exists(select_traj):
            # custom TUM-format folder (ref TUM_RGBD.py:301-331)
            self.calib.append(TUM_CALIB)
            traj = load_sync_trajectory(select_traj)
            idxs = list(range(0, len(traj), kf))
            self.image_seq.append([traj[i][1] for i in idxs])
            self.depth_seq.append([traj[i][2] for i in idxs])
            self.cam_pose_seq.append([tq_to_matrix4(traj[i][0]) for i in idxs])
            self.seq_names.append(os.path.basename(select_traj))
            self.ids += max(0, len(idxs) - 1)
            self.seq_acc_ids.append(self.ids)

    # ------------------------------------------------------------------
    def __len__(self):
        return self.ids

    def _locate(self, index):
        seq_idx = max(np.searchsorted(self.seq_acc_ids, index + 1) - 1, 0)
        return seq_idx, index - self.seq_acc_ids[seq_idx]

    def _load_pair(self, seq_idx, idx0, idx1) -> Dict[str, np.ndarray]:
        color0 = read_rgb(self.image_seq[seq_idx][idx0], self.fx_s)
        color1 = read_rgb(self.image_seq[seq_idx][idx1], self.fx_s)
        clip = (0.5, 5.0) if self.truncate_depth else None
        depth0 = read_depth_png(self.depth_seq[seq_idx][idx0], 5000.0, self.fx_s, clip)
        depth1 = read_depth_png(self.depth_seq[seq_idx][idx1], 5000.0, self.fx_s, clip)
        if self.augment is not None:
            color0, color1 = self.augment([color0, color1])
        calib = np.asarray(self.calib[seq_idx], dtype=np.float32)
        calib = calib * np.asarray([self.fx_s, self.fy_s, self.fx_s, self.fy_s])
        pose0 = self.cam_pose_seq[seq_idx][idx0]
        pose1 = self.cam_pose_seq[seq_idx][idx1]
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
                "frame0": idx0,
                "frame1": idx1,
            },
        }

    def __getitem__(self, index):
        seq_idx, frame_idx = self._locate(index)
        next_idx = frame_idx + random.choice(self.keyframes)
        return self._load_pair(seq_idx, frame_idx, next_idx)

    def get_keypair(self, index, kf_idx: int = 0):
        """Pair frame ``index`` against keyframe ``kf_idx`` (keyframe VO)."""
        seq_idx, frame_idx = self._locate(index)
        return self._load_pair(seq_idx, kf_idx, frame_idx)

    def pair_frames(self, idx0: int, idx1: int, seq_idx: int = 0):
        """Direct frame-pair access by raw frame indices (VO / BA frontends)."""
        return self._load_pair(seq_idx, idx0, idx1)

    def num_frames(self, seq_idx: int = 0) -> int:
        return len(self.image_seq[seq_idx])
