"""Multi-keyframe trajectory refinement: VO and windowed pose-graph BA.

Counterpart of ``deep_prob_feature_track_tpu/apps/ba_refine.py``: tracks
every frame pair within a sliding window of keyframes (a batch of pairs a
forward), takes each pair's relative pose and 6x6 information matrix (the
``uncer_prop`` tracker's ``JtWJ``), chains the odometry edges into an
initial trajectory and refines it with the pose-graph back end
(``parallel/ba.py``); with ``--dense`` the dense feature-metric window
refinement (``parallel/dense_ba.py``) follows, on one pyramid level of
every frame's encoding.  Writes a TUM-format trajectory file and prints
the ATE-RMSE before and after where the sequence has ground truth.  Runs
on the card unless ``--device cpu``::

    python -m deep_prob_feature_track_torch.apps.ba_refine --data_root "" \
        --trajectory /path/to/sequence --preset feature --checkpoint ckpt.pt \
        --window 3 --dense

The checkpoint is a tracker ``state_dict`` or a training state written by
``apps/train.py`` (``apps/import_checkpoint`` imports one of the original
implementation); without one the weights are a seeded init.  The pose
graph and the dense window run in float32 on the device, as the tracker
does; the chaining of the odometry runs on the host in float64.

``--sharded`` splits the pose graph's edges over the ranks of a mesh
(``parallel/mesh.py``: the ranks ``torchrun`` starts, or this process
alone), padding them to a multiple of the world size with zero-information
edges; every rank tracks the window, and rank 0 alone writes the trajectory::

    torchrun --nproc_per_node 4 -m deep_prob_feature_track_torch.apps.ba_refine \
        --data_root "" --trajectory /path/to/sequence --sharded
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

KEYS = ("color0", "color1", "depth0", "depth1", "calib")


def window_pairs(n_frames: int, window: int) -> List[Tuple[int, int]]:
    """All (i, j) pairs with 0 < j - i <= window."""
    pairs = []
    for i in range(n_frames):
        for j in range(i + 1, min(i + window + 1, n_frames)):
            pairs.append((i, j))
    return pairs


def track_pairs(dataset, pairs, forward_fn, batch_size: int = 8, device="cuda"):
    """Track a list of frame pairs, ``batch_size`` pairs a forward.  A last
    partial chunk is padded with copies of its last pair, which enter the
    forward's batch-global reductions, as in the JAX function.

    :param forward_fn: ``(color0, color1, depth0, depth1, K) -> (R, t,
        JtWJ)`` on tensors on ``device``
    :param device: the card unless ``"cpu"`` is asked for
    :return: ``(meas, infos)``: a list of ``(R, t)`` and one of [6,6]
        numpy arrays
    """
    from ..device import resolve_device

    device = resolve_device(device)
    meas, infos = [], []
    for start in range(0, len(pairs), batch_size):
        chunk = pairs[start:start + batch_size]
        chunk_p = chunk + [chunk[-1]] * (batch_size - len(chunk))
        items = [dataset.pair_frames(i, j) for (i, j) in chunk_p]
        batch = [torch.from_numpy(np.stack([it[k] for it in items])).to(device) for k in KEYS]
        with torch.inference_mode():
            R, t, JtWJ = (x.cpu().numpy() for x in forward_fn(*batch))
        for b in range(len(chunk)):
            meas.append((R[b], t[b]))
            infos.append(JtWJ[b])
    return meas, infos


def track_window(net, dataset, n_frames: int, window: int, batch_size: int = 8,
                 device="cuda"):
    """Track every window pair of the first ``n_frames`` frames with the
    ``uncer_prop`` tracker ``net`` and chain the odometry edges (j = i+1)
    into an initial trajectory, on the host in float64.

    :param device: the card unless ``"cpu"`` is asked for
    :return: ``(pairs, meas, infos, poses [n_frames,4,4])``
    """
    def forward(*batch):
        (R, t), JtWJ = net(*batch)
        return R, t, JtWJ

    pairs = window_pairs(n_frames, window)
    meas, infos = track_pairs(dataset, pairs, forward, batch_size, device)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    odo = {(i, j): k for k, (i, j) in enumerate(pairs) if j == i + 1}
    for i in range(n_frames - 1):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = meas[odo[(i, i + 1)]]
        poses[i + 1] = poses[i] @ np.linalg.inv(T)
    return pairs, meas, infos, poses


def encode_frames(net, dataset, n_frames: int, level: int, device="cuda"):
    """The dense window's maps: every frame encoded once, as the template
    of the pair (i, i+1) (the last frame paired with itself), since the
    two-view encoder reads both frames; pyramid level ``level``.

    :param device: the card unless ``"cpu"`` is asked for
    :return: ``parallel.dense_ba.WindowFrames`` on ``device``
    """
    from ..device import resolve_device
    from ..geometry.warp import scale_K
    from ..parallel.dense_ba import WindowFrames

    device = resolve_device(device)
    feats, sigmas, invds, Ks = [], [], [], []
    for i in range(n_frames):
        it = dataset.pair_frames(i, min(i + 1, n_frames - 1))
        c0, c1, d0, d1, K = (torch.from_numpy(it[k][None]).to(device) for k in KEYS)
        with torch.inference_mode():
            x0, _, s0, _, iv0, *_ = net._preprocess(c0, c1, d0, d1)
        feats.append(x0[level][0])
        sigmas.append(s0[level][0])
        invds.append(iv0[level][0])
        Ks.append(scale_K(K, level)[0])
    return WindowFrames(*(torch.stack(x) for x in (feats, sigmas, invds, Ks)))


def build_argparser():
    p = argparse.ArgumentParser(description="Windowed multi-keyframe BA refinement")
    p.add_argument("--dataset", default="TUM_RGBD")
    p.add_argument("--data_root", default=None)
    p.add_argument("--trajectory", required=True)
    p.add_argument("--preset", default="feature")
    p.add_argument("--checkpoint", default="",
                   help="a tracker state_dict or a training state (.pt)")
    p.add_argument("--keyframe", type=int, default=1)
    p.add_argument("--window", type=int, default=3)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_resize", type=float, default=0.25)
    p.add_argument("--sharded", action="store_true", help="shard edges over the mesh")
    p.add_argument("--dense", action="store_true",
                   help="follow the pose-graph solve with dense feature-metric "
                        "window refinement (direct multi-frame alignment)")
    p.add_argument("--dense_level", type=int, default=1,
                   help="feature-pyramid level for the dense refinement")
    p.add_argument("--dense_iterations", type=int, default=5)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--output", default="ba_trajectory.txt")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from ..device import resolve_device
    from ..parallel.mesh import destroy, make_mesh

    device = resolve_device(args.device)
    mesh = make_mesh(device) if args.sharded else None
    try:
        return refine(args, mesh.device if mesh else device, mesh)
    finally:
        if mesh is not None:
            destroy()


def refine(args, device, mesh) -> int:
    """The CLI's work after the mesh is made: track, refine, write."""
    from ..data.loader import load_data
    from ..parallel import ba
    from .kf_vo import ate_rmse, write_tum_trajectory
    from .serve import build_tracker

    main_process = mesh is None or mesh.is_main
    dataset = load_data(
        args.dataset, [args.keyframe], "test", select_traj=args.trajectory,
        image_resize=args.image_resize, root=args.data_root,
    )
    n_frames = dataset.num_frames()
    if args.max_frames:
        n_frames = min(n_frames, args.max_frames)
    net = build_tracker(args.preset, args.checkpoint, device, overrides=["uncer_prop=1"])

    print(f"[ba_refine] tracking {len(window_pairs(n_frames, args.window))} window edges "
          f"over {n_frames} frames")
    pairs, meas, infos, poses = track_window(net, dataset, n_frames, args.window,
                                             args.batch_size, device)
    graph = ba.build_window_graph(poses, pairs, meas, infos, device=device,
                                  dtype=torch.float32)
    if mesh is None:
        refined, costs = ba.refine_pose_graph(graph, args.iterations)
    else:
        pad = (-len(pairs)) % mesh.world
        padded = ba.build_window_graph(
            poses, pairs + [pairs[0]] * pad, meas + [meas[0]] * pad,
            list(infos) + [np.zeros((6, 6))] * pad, device=device, dtype=torch.float32)
        refined, costs = ba.refine_pose_graph_sharded(padded, mesh, args.iterations)
    costs = costs.cpu().numpy()
    print(f"[ba_refine] cost {float(costs[0]):.4f} -> {float(costs[-1]):.6f}")
    refined_poses = np.tile(np.eye(4), (n_frames, 1, 1))
    refined_poses[:, :3, :3] = refined.R.cpu().numpy()
    refined_poses[:, :3, 3] = refined.t.cpu().numpy()

    if args.dense:
        from ..parallel.dense_ba import refine_dense_window

        lvl = args.dense_level
        print(f"[ba_refine] dense refinement at pyramid level {lvl}")
        window = encode_frames(net, dataset, n_frames, lvl, device)
        Rd, td, dcosts = refine_dense_window(
            window, refined.R, refined.t, graph.edges_i, graph.edges_j,
            iterations=args.dense_iterations,
        )
        dcosts = dcosts.cpu().numpy()
        print(f"[ba_refine] dense cost {float(dcosts[0]):.4f} -> {float(dcosts[-1]):.4f}")
        refined_poses[:, :3, :3] = Rd.cpu().numpy()
        refined_poses[:, :3, 3] = td.cpu().numpy()

    if not main_process:
        return 0
    write_tum_trajectory(args.output, refined_poses)
    print(f"[ba_refine] wrote {args.output}")

    if getattr(dataset, "cam_pose_seq", None):
        gt_abs = np.stack(dataset.cam_pose_seq[0][:n_frames])
        gt = np.linalg.inv(gt_abs[0])[None] @ gt_abs
        before = ate_rmse(poses[:, :3, 3], gt[:, :3, 3])
        after = ate_rmse(refined_poses[:, :3, 3], gt[:, :3, 3])
        print(f"[ba_refine] ATE-RMSE: odometry {before * 100:.2f} cm -> "
              f"refined {after * 100:.2f} cm")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
