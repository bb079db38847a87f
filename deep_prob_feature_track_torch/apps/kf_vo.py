"""Keyframe visual-odometry front end (headless).

Counterpart of ``deep_prob_feature_track_tpu/apps/kf_vo.py``: per frame
the tracker estimates the pose against the previous frame (incremental) or
against the current keyframe (keyframe mode), chains ``T_WC = T_WK @
inv(T_CK)``, reports drift against the ground truth where the sequence has
it, and writes a TUM-format trajectory file (``timestamp tx ty tz qx qy qz
qw``) with the ATE-RMSE against the ground truth.  Each frame is one B=1
forward of ``apps/serve.py::build_tracker``'s tracker on the card
(``--device cpu`` for the CPU); the chaining runs on the host in float64.

    python -m deep_prob_feature_track_torch.apps.kf_vo --data_root "" \
        --trajectory /path/to/sequence --vo feature --checkpoint ckpt.pt \
        --vo_type keyframe
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

KEYS = ("color0", "color1", "depth0", "depth1", "calib")
KF_DRIFT_WARN = 0.02  # m of drift from the ground truth that a verbose run prints


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error of positions ``[N,3]`` after the rigid
    (rotation + translation, no scale) alignment of the estimate to GT."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = (U @ S @ Vt).T
    aligned = (R @ E.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def run_vo(
    dataset,
    forward_fn,
    vo_type: str = "keyframe",
    kf_switch_dist: float = 0.25,
    kf_switch_angle: float = 0.35,
    verbose: bool = False,
    use_gt: bool = False,
    device="cuda",
):
    """Track a whole sequence.

    Keyframe mode tracks every frame against the current keyframe and
    makes the frame the new keyframe when the relative motion exceeds
    ``kf_switch_dist`` (m) or ``kf_switch_angle`` (rad);
    ``kf_switch_dist=inf`` (and the angle) keeps frame 0 for ever.

    :param dataset: test-mode dataset with ``pair_frames``, ``num_frames``
        and ``__getitem__``
    :param forward_fn: ``(color0, color1, depth0, depth1, K) -> (R [1,3,3],
        t [1,3])`` on tensors on ``device``
    :param use_gt: chain the dataset's ground-truth relative poses instead
        of tracking: the trajectory then reproduces the ground truth, which
        isolates the chaining and keyframe logic from tracking error
    :return: ``(poses_est [N,4,4] world-from-camera, poses_gt or None)``
    """
    n = dataset.num_frames() if hasattr(dataset, "num_frames") else len(dataset) + 1
    T_WC = np.eye(4)
    T_WK = np.eye(4)  # world-from-keyframe
    kf_idx = 0
    poses = [T_WC.copy()]
    gt_abs = [np.eye(4)]
    have_gt = True

    for i in range(1, n):
        # keyframe mode pairs frame i with the keyframe, so that pose i is
        # frame i's in both modes
        item = dataset.pair_frames(kf_idx, i) if vo_type == "keyframe" else dataset[i - 1]
        if use_gt:
            if item.get("transform") is None:
                raise ValueError("--gt_tracker needs a dataset with GT poses")
            T_CK = np.asarray(item["transform"], np.float64)
        else:
            args = tuple(torch.from_numpy(np.asarray(item[k])[None]).to(device) for k in KEYS)
            with torch.inference_mode():
                R, t = forward_fn(*args)
            T_CK = np.eye(4)  # live-from-reference
            T_CK[:3, :3] = R[0].cpu().numpy()
            T_CK[:3, 3] = t[0].cpu().numpy()
        if vo_type == "keyframe":
            T_WC = T_WK @ np.linalg.inv(T_CK)
        else:
            T_WC = T_WC @ np.linalg.inv(T_CK)
        poses.append(T_WC.copy())

        transform = item.get("transform")
        if transform is None:
            have_gt = False
        elif have_gt:
            # the ground truth chains the way the estimate does
            base = gt_abs[kf_idx] if vo_type == "keyframe" else gt_abs[-1]
            gt_abs.append(base @ np.linalg.inv(np.asarray(transform, np.float64)))
            drift = np.linalg.norm(poses[-1][:3, 3] - gt_abs[-1][:3, 3])
            if verbose and drift > KF_DRIFT_WARN:
                print(f"[kf_vo] frame {i}: drift {drift * 100:.2f}cm")

        if vo_type == "keyframe":
            trs = np.linalg.norm(T_CK[:3, 3])
            ang = np.arccos(np.clip((np.trace(T_CK[:3, :3]) - 1) / 2, -1, 1))
            if trs > kf_switch_dist or ang > kf_switch_angle:
                kf_idx = i
                T_WK = T_WC.copy()
                if verbose:
                    print(f"[kf_vo] frame {i}: new keyframe (|t|={trs:.3f}, ang={ang:.3f})")

    poses = np.stack(poses)
    gt = np.stack(gt_abs) if (have_gt and len(gt_abs) == len(poses)) else None
    return poses, gt


def write_tum_trajectory(path: str, poses: np.ndarray, timestamps=None):
    """Write poses [N,4,4] as TUM ``stamp tx ty tz qx qy qz qw`` lines."""
    from ..geometry.lie import matrix_to_quat

    quats = matrix_to_quat(torch.from_numpy(np.ascontiguousarray(poses[:, :3, :3]))).numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for i, (T, q) in enumerate(zip(poses, quats)):
            ts = timestamps[i] if timestamps is not None else float(i)
            tx, ty, tz = T[:3, 3]
            f.write(
                f"{ts} {tx:.6f} {ty:.6f} {tz:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def main(argv=None):
    p = argparse.ArgumentParser(description="Keyframe visual odometry")
    p.add_argument("--dataset", default="TUM_RGBD")
    p.add_argument("--data_root", default=None)
    p.add_argument("--trajectory", required=True)
    p.add_argument("--vo", default="feature",
                   choices=("DeepIC", "RGB", "ICP", "RGB+ICP", "feature", "feature_icp"))
    p.add_argument("--vo_type", default="incremental", choices=("incremental", "keyframe"))
    p.add_argument("--checkpoint", default="",
                   help="a tracker state_dict or a training state (.pt)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any TrackerConfig field on top of --vo")
    p.add_argument("--gt_tracker", action="store_true",
                   help="chain the ground-truth relative poses instead of tracking")
    p.add_argument("--image_resize", type=float, default=0.25)
    p.add_argument("--output", default="vo_trajectory.txt")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data.loader import load_data
    from ..device import resolve_device
    from .serve import build_tracker

    device = resolve_device(args.device)
    dataset = load_data(
        args.dataset, [1], "test", select_traj=args.trajectory,
        image_resize=args.image_resize, root=args.data_root,
    )
    net = build_tracker(args.vo, args.checkpoint, device, overrides=args.set)
    poses, gt = run_vo(dataset, net, vo_type=args.vo_type, verbose=args.verbose,
                       use_gt=args.gt_tracker, device=device)
    write_tum_trajectory(args.output, poses)
    print(f"[kf_vo] wrote {len(poses)} poses to {args.output}")
    if gt is not None:
        print(f"[kf_vo] ATE-RMSE vs GT: {ate_rmse(poses[:, :3, 3], gt[:, :3, 3]) * 100:.2f} cm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
