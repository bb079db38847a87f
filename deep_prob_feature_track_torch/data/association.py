"""TUM RGB-D timestamp association (rgb <-> depth <-> groundtruth).

Counterpart of ``deep_prob_feature_track_tpu/data/association.py``: greedy
nearest-timestamp matching within a search radius over three streams, and
the ``sync_trajectory.pkl`` cache of a sequence directory.  The cache holds
the same list of ``[pose7, rgb_path, depth_path]`` as the JAX package's, so
either package reads the other's.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np


def read_file_list(filename: str) -> Dict[float, List[str]]:
    """Parse a TUM-format 'stamp d1 d2 ...' text file into {stamp: fields}."""
    with open(filename) as f:
        data = f.read()
    out = {}
    for line in data.replace(",", " ").replace("\t", " ").split("\n"):
        if not line or line.startswith("#"):
            continue
        fields = [v.strip() for v in line.split(" ") if v.strip()]
        if len(fields) > 1:
            out[float(fields[0])] = fields[1:]
    return out


def associate_three(
    first: Dict[float, list],
    second: Dict[float, list],
    third: Dict[float, list],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float, float]]:
    """Greedy three-way association by minimal timestamp difference.

    Matches rgb<->depth candidates first, then attaches poses; each stamp is
    consumed at most once, smallest differences first.
    """
    pot_ab = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first
        for b in second
        if abs(a - (b + offset)) < max_difference
    )
    matches_ab = sorted((a, b) for _, a, b in pot_ab)

    pot_abc = sorted(
        (abs(a - (c + offset)), abs(b - (c + offset)), a, b, c)
        for (a, b) in matches_ab
        for c in third
        if abs(a - (c + offset)) < max_difference
        and abs(b - (c + offset)) < max_difference
    )
    fa, fb, fc = set(first), set(second), set(third)
    matches = []
    for _, _, a, b, c in pot_abc:
        if a in fa and b in fb and c in fc:
            fa.remove(a)
            fb.remove(b)
            fc.remove(c)
            matches.append((a, b, c))
    matches.sort()
    return matches


def write_sync_trajectory(seq_dir: str) -> str:
    """Associate rgb/depth/groundtruth of one sequence directory and cache a
    ``sync_trajectory.pkl`` of [pose(7), rgb_path, depth_path] triplets."""
    rgb_list = read_file_list(os.path.join(seq_dir, "rgb.txt"))
    depth_list = read_file_list(os.path.join(seq_dir, "depth.txt"))
    pose_list = read_file_list(os.path.join(seq_dir, "groundtruth.txt"))
    trajectory = [
        [
            [float(x) for x in pose_list[c]],
            os.path.join(seq_dir, rgb_list[a][0]),
            os.path.join(seq_dir, depth_list[b][0]),
        ]
        for a, b, c in associate_three(rgb_list, depth_list, pose_list)
    ]
    out_path = os.path.join(seq_dir, "sync_trajectory.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(trajectory, f)
    return out_path


def load_sync_trajectory(seq_dir: str):
    """Load (building if necessary) the cached synchronized trajectory."""
    path = os.path.join(seq_dir, "sync_trajectory.pkl")
    if not os.path.isfile(path):
        path = write_sync_trajectory(seq_dir)
    with open(path, "rb") as f:
        return pickle.load(f)


def tq_to_matrix4(tq) -> np.ndarray:
    """[tx,ty,tz,qx,qy,qz,qw] -> 4x4 pose matrix (float64)."""
    tq = np.asarray(tq, dtype=np.float64)
    t, (x, y, z, w) = tq[:3], tq[3:]
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    T = np.eye(4)
    T[:3, :3] = [
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ]
    T[:3, 3] = t
    return T
