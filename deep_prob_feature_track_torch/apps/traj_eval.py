"""Trajectory evaluation: ATE / RPE between two TUM-format files.

Counterpart of ``deep_prob_feature_track_tpu/apps/traj_eval.py``, a copy
on numpy and the standard library: the headless equivalent of the TUM
benchmark's evaluate_ate.py / evaluate_rpe.py scripts, for the
trajectories ``apps/kf_vo.py`` writes.  Association is by nearest
timestamp, as ``data/association.py`` pairs rgb and depth.

Usage::

    python -m deep_prob_feature_track_torch.apps.traj_eval \
        --est vo_trajectory.txt --gt groundtruth.txt [--delta 1]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read 'stamp tx ty tz qx qy qz qw' lines -> (stamps [N], T [N,4,4])."""
    stamps: List[float] = []
    mats: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) < 8:
                continue
            stamps.append(vals[0])
            t = np.asarray(vals[1:4])
            qx, qy, qz, qw = vals[4:8]
            # quaternion (x,y,z,w) -> rotation matrix
            n = qx * qx + qy * qy + qz * qz + qw * qw
            s = 0.0 if n == 0 else 2.0 / n
            R = np.asarray(
                [
                    [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw), s * (qx * qz + qy * qw)],
                    [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz), s * (qy * qz - qx * qw)],
                    [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw), 1 - s * (qx * qx + qy * qy)],
                ]
            )
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            mats.append(T)
    if not mats:
        raise ValueError(f"no poses in {path}")
    return np.asarray(stamps), np.stack(mats)


def associate(stamps_a, stamps_b, max_dt: float = 0.02):
    """Greedy nearest-timestamp matching (the TUM benchmark's associate)."""
    ia = np.argsort(stamps_a)
    ib = np.argsort(stamps_b)
    pairs = []
    j = 0
    for i in ia:
        while j + 1 < len(ib) and abs(stamps_b[ib[j + 1]] - stamps_a[i]) <= abs(
            stamps_b[ib[j]] - stamps_a[i]
        ):
            j += 1
        if abs(stamps_b[ib[j]] - stamps_a[i]) <= max_dt:
            pairs.append((i, ib[j]))
    return pairs


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE-RMSE after SE(3) (no-scale Umeyama) alignment of positions."""
    pe, pg = est[:, :3, 3], gt[:, :3, 3]
    mu_e, mu_g = pe.mean(0), pg.mean(0)
    E, G = pe - mu_e, pg - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = (U @ S @ Vt).T
    aligned = (R @ E.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - pg) ** 2, axis=1))))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """RPE over frame gaps of ``delta``: (trans RMSE [m], rot RMSE [rad])."""
    d_t, d_r = [], []
    for i in range(len(est) - delta):
        E = np.linalg.inv(est[i]) @ est[i + delta]
        G = np.linalg.inv(gt[i]) @ gt[i + delta]
        D = np.linalg.inv(G) @ E
        d_t.append(np.linalg.norm(D[:3, 3]))
        d_r.append(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1.0, 1.0)))
    return (
        float(np.sqrt(np.mean(np.square(d_t)))),
        float(np.sqrt(np.mean(np.square(d_r)))),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="ATE/RPE between TUM trajectories")
    p.add_argument("--est", required=True, help="estimated trajectory (TUM format)")
    p.add_argument("--gt", required=True, help="ground-truth trajectory (TUM format)")
    p.add_argument("--delta", type=int, default=1, help="RPE frame gap")
    p.add_argument("--max_dt", type=float, default=0.02,
                   help="max timestamp difference for association [s]")
    args = p.parse_args(argv)

    se, te = load_tum_trajectory(args.est)
    sg, tg = load_tum_trajectory(args.gt)
    pairs = associate(se, sg, max_dt=args.max_dt)
    if len(pairs) < 2:
        raise SystemExit(
            f"only {len(pairs)} associated poses (est {len(se)}, gt {len(sg)}); "
            f"raise --max_dt?"
        )
    e = te[[i for i, _ in pairs]]
    g = tg[[j for _, j in pairs]]
    rpe_t, rpe_r = rpe(e, g, delta=args.delta)
    print(
        json.dumps(
            {
                "pairs": len(pairs),
                "ate_rmse_m": round(ate(e, g), 6),
                "rpe_trans_rmse_m": round(rpe_t, 6),
                "rpe_rot_rmse_deg": round(np.degrees(rpe_r), 6),
                "delta": args.delta,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
