"""How well ``ba_refine``'s pose graph pins its gauge, with the seeded
``feature`` tracker (``chip_smoke.py`` phase 48's checkpoint, seed 5).

Writes ``chip_smoke.write_tum_sequence`` into a temporary directory, tracks
``ba_refine``'s window pairs (window 3) and chains the odometry with
``ba_refine.track_window``, the CLI's own, and refines the pose graph (10
iterations) in float32 and in float64 from the same measurements and
information matrices.  Prints one
JSON object per case (120x160 over 24 frames, 640x480 over the first 4)
with

- ``info_max``, ``info_min_eig``: the largest entry and the smallest
  eigenvalue of the edges' information matrices (the anchor on pose 0 is
  1e6);
- ``pose0_moved_f64``: how far the float64 refinement moves pose 0;
- ``f32_vs_f64``: the largest gap of the refined poses, as written and
  taken relative to frame 0 (free of the gauge);
- ``meas_1e-6``, ``info_1e-6``: how far the float64 refined translations
  move when every measured translation moves by 1e-6, or every
  information matrix by 1e-6 of itself.

    python3 scripts/torch_ba_gauge.py               # on the card
    python3 scripts/torch_ba_gauge.py --device cpu  # on the CPU (~40 s)
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import write_tum_sequence  # noqa: E402
from deep_prob_feature_track_torch.apps import ba_refine  # noqa: E402
from deep_prob_feature_track_torch.apps.serve import build_tracker  # noqa: E402
from deep_prob_feature_track_torch.data.loader import load_data  # noqa: E402
from deep_prob_feature_track_torch.models.presets import get_preset  # noqa: E402
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking  # noqa: E402
from deep_prob_feature_track_torch.parallel import ba  # noqa: E402
from deep_prob_feature_track_torch.training.checkpoints import save_variables  # noqa: E402


def refine(poses, pairs, meas, infos, dtype, device):
    graph = ba.build_window_graph(poses, pairs, meas, infos, device=device, dtype=dtype)
    g, _ = ba.refine_pose_graph(graph, 10)
    T = np.tile(np.eye(4), (len(poses), 1, 1))
    T[:, :3, :3] = g.R.double().cpu().numpy()
    T[:, :3, 3] = g.t.double().cpu().numpy()
    return T


def case(seq, ckpt, scale, n, device):
    ds = load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=scale, root="")
    net = build_tracker("feature", ckpt, device, overrides=["uncer_prop=1"])
    pairs, meas, infos, poses = ba_refine.track_window(net, ds, n, 3, 8, device)
    f64 = refine(poses, pairs, meas, infos, torch.float64, device)
    f32 = refine(poses, pairs, meas, infos, torch.float32, device)

    def from_first(T):
        return np.linalg.inv(T[0])[None] @ T

    rng = np.random.RandomState(0)
    shifted = [(R, t + 1e-6) for R, t in meas]
    scaled = []
    for info in infos:
        noisy = info * (1 + 1e-6 * rng.randn(6, 6))
        scaled.append(0.5 * (noisy + noisy.T))
    return {
        "size": f"{int(480 * scale)}x{int(640 * scale)}", "frames": n, "edges": len(pairs),
        "info_max": float(max(np.abs(i).max() for i in infos)),
        "info_min_eig": float(min(np.linalg.eigvalsh(i.astype(np.float64)).min()
                                  for i in infos)),
        "pose0_moved_f64": float(np.abs(f64[0] - np.eye(4)).max()),
        "f32_vs_f64": float(np.abs(f32 - f64).max()),
        "f32_vs_f64_from_first": float(np.abs(from_first(f32) - from_first(f64)).max()),
        "meas_1e-6": float(np.abs(refine(poses, pairs, shifted, infos, torch.float64, device)
                                  - f64)[:, :3, 3].max()),
        "info_1e-6": float(np.abs(refine(poses, pairs, meas, scaled, torch.float64, device)
                                  - f64)[:, :3, 3].max()),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq")
        write_tum_sequence(seq)
        ckpt = save_variables(os.path.join(tmp, "ba.pt"), LeastSquareTracking(
            get_preset("feature")).reset_parameters(5).state_dict())
        for scale, n in ((0.25, 24), (1.0, 4)):
            print(json.dumps(case(seq, ckpt, scale, n, torch.device(args.device))), flush=True)


if __name__ == "__main__":
    main()
