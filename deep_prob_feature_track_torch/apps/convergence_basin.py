"""Convergence-basin / cost-landscape study.

Counterpart of ``deep_prob_feature_track_tpu/apps/convergence_basin.py``:
perturb the ground-truth pose per axis (1D: 6 axes x N samples) or on an
x/y translation grid (2D: NxN) and evaluate the tracker's average residual
(``LeastSquareTracking.compute_residual``) at every perturbation and
pyramid level.  The perturbations run in chunks stacked along the batch:
the pair is tiled to the chunk, the last chunk padded with identity poses,
one ``compute_residual`` call a chunk and level (one K1 launch for the
``feature`` preset).

Perturbation ranges follow the keyframe gap: +-0.15 / 0.20 / 0.25 / 0.30
for keyframes 1 / 2 / 4 / 8.  The pickle has the JAX tool's keys; the
plots (``--save_img``) need matplotlib, imported only there.

    python -m deep_prob_feature_track_torch.apps.convergence_basin \
        --data_root "" --trajectory /path/to/sequence --cb_dimension 2D
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict

import numpy as np
import torch

from ..geometry.lie import compose, exp_so3

PERT_RANGE_BY_KF = {1: 0.15, 2: 0.20, 4: 0.25, 8: 0.30}
KEYS = ("color0", "color1", "depth0", "depth1", "calib")


def perturbation_poses_1d(R_gt, t_gt, pert_range: float, samples: int):
    """Per-axis SE(3) perturbations ``exp(xi) o T_gt`` of the GT pose,
    float32, on the CPU.

    :return: ((R [6,S,3,3], t [6,S,3]), offsets [S])
    """
    offsets = np.linspace(-pert_range, pert_range, samples)
    R = torch.as_tensor(np.asarray(R_gt, np.float32)).expand(samples, 3, 3)
    t = torch.as_tensor(np.asarray(t_gt, np.float32)).expand(samples, 3)
    all_R, all_t = [], []
    for axis in range(6):
        xi = np.zeros((samples, 6), np.float32)
        xi[:, axis] = offsets
        xi = torch.from_numpy(xi)
        Rp, tp = compose(exp_so3(xi[:, :3]), xi[:, 3:], R, t)
        all_R.append(Rp)
        all_t.append(tp)
    return (torch.stack(all_R), torch.stack(all_t)), offsets


def perturbation_poses_2d(R_gt, t_gt, pert_range: float, samples: int):
    """The GT pose with its x/y translation moved over an SxS grid.

    :return: ((R [S*S,3,3], t [S*S,3]), offsets [S])
    """
    offsets = np.linspace(-pert_range, pert_range, samples)
    xx, yy = np.meshgrid(offsets, offsets, indexing="ij")
    P = samples * samples
    t = np.tile(np.asarray(t_gt, np.float32), (P, 1))
    t[:, 0] += xx.reshape(-1)
    t[:, 1] += yy.reshape(-1)
    R = torch.as_tensor(np.asarray(R_gt, np.float32)).expand(P, 3, 3)
    return (R, torch.from_numpy(t)), offsets


def evaluate_basin(net, item: Dict[str, np.ndarray], poses, levels=(0, 1, 2, 3),
                   chunk: int = 64, device="cuda") -> np.ndarray:
    """Residual landscape ``cost [len(levels), *poses' batch shape]`` of
    ``net`` (on ``device``) for the pair ``item``."""
    R_all, t_all = poses
    flat_R = R_all.reshape(-1, 3, 3).to(device)
    flat_t = t_all.reshape(-1, 3).to(device)
    P = flat_R.shape[0]
    n_chunks = (P + chunk - 1) // chunk
    pad = n_chunks * chunk - P
    if pad:
        flat_R = torch.cat([flat_R, torch.eye(3, dtype=flat_R.dtype, device=device).expand(
            pad, 3, 3)])
        flat_t = torch.cat([flat_t, flat_t.new_zeros((pad, 3))])
    tiled = [torch.from_numpy(np.asarray(item[k])).to(device)[None].expand(
        (chunk,) + np.shape(item[k])) for k in KEYS]
    costs = []
    with torch.inference_mode():
        for level in levels:
            level_costs = [
                net.compute_residual(*tiled, pose_init=(flat_R[c * chunk:(c + 1) * chunk],
                                                        flat_t[c * chunk:(c + 1) * chunk]),
                                     level=level)[1]
                for c in range(n_chunks)]
            costs.append(torch.cat(level_costs)[:P])
    out = torch.stack(costs).cpu().numpy()  # [L, P]
    return out.reshape((len(levels),) + tuple(R_all.shape[:-2]))


def save_plots(data: Dict, out_prefix: str):
    """Cost-landscape figures, rendered headless (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    costs = data["costs"]
    offsets = data["offsets"]
    if data["dimension"] == "1D":
        axes_names = ["rot-x", "rot-y", "rot-z", "trans-x", "trans-y", "trans-z"]
        fig, axs = plt.subplots(2, 3, figsize=(14, 7), sharex=True)
        for a in range(6):
            ax = axs[a // 3][a % 3]
            for lvl in range(costs.shape[0]):
                ax.plot(offsets, costs[lvl, a], label=f"level {lvl}")
            ax.set_title(axes_names[a])
            ax.axvline(0.0, color="k", lw=0.5)
        axs[0][0].legend(fontsize=7)
        fig.suptitle(f"cost landscape ({data['trajectory']}, kf {data['keyframe']})")
        fig.tight_layout()
        fig.savefig(out_prefix + "_1d.png", dpi=110)
        plt.close(fig)
    else:
        n = costs.shape[0]
        S = len(offsets)
        fig, axs = plt.subplots(1, n, figsize=(4 * n, 3.6))
        for lvl in range(n):
            ax = axs[lvl] if n > 1 else axs
            im = ax.contourf(offsets, offsets, costs[lvl].reshape(S, S).T, levels=20)
            ax.plot(0, 0, "r+")
            ax.set_title(f"level {lvl}")
            fig.colorbar(im, ax=ax)
        fig.suptitle("x/y translation cost landscape")
        fig.tight_layout()
        fig.savefig(out_prefix + "_2d.png", dpi=110)
        plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description="Convergence-basin sweep")
    p.add_argument("--dataset", default="TUM_RGBD")
    p.add_argument("--data_root", default=None)
    p.add_argument("--trajectory", required=True)
    p.add_argument("--preset", default="feature")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--keyframe", type=int, default=1)
    p.add_argument("--cb_dimension", default="2D", choices=("1D", "2D"))
    p.add_argument("--pert_samples", type=int, default=31)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--image_resize", type=float, default=0.25)
    p.add_argument("--output", default="convergence_basin.pkl")
    p.add_argument("--save_img", action="store_true", help="write landscape plots")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data.loader import load_data
    from ..device import resolve_device
    from .serve import build_tracker

    dataset = load_data(
        args.dataset, [args.keyframe], "test", select_traj=args.trajectory,
        image_resize=args.image_resize, root=args.data_root,
    )
    item = dataset[args.frame]
    device = resolve_device(args.device)
    net = build_tracker(args.preset, args.checkpoint, device)

    T = np.asarray(item["transform"])
    R_gt, t_gt = T[:3, :3], T[:3, 3]
    rng = PERT_RANGE_BY_KF.get(args.keyframe, 0.15)
    if args.cb_dimension == "1D":
        poses, offsets = perturbation_poses_1d(R_gt, t_gt, rng, args.pert_samples)
    else:
        poses, offsets = perturbation_poses_2d(R_gt, t_gt, rng, args.pert_samples)

    costs = evaluate_basin(net, item, poses, device=device)
    data = {
        "costs": costs,
        "offsets": offsets,
        "dimension": args.cb_dimension,
        "pert_range": rng,
        "trajectory": args.trajectory,
        "frame": args.frame,
        "keyframe": args.keyframe,
    }
    with open(args.output, "wb") as f:
        pickle.dump(data, f)
    if args.save_img:
        save_plots(data, args.output.replace(".pkl", ""))
    print(f"[convergence_basin] costs {costs.shape} -> {args.output}")
    print(f"  min cost per level: {costs.reshape(costs.shape[0], -1).min(axis=1)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
