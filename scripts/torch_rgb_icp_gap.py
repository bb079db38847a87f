"""Where the kernel and plain forwards of the ``RGB+ICP`` preset part.

Runs the preset's eval forward on ``example_batch(8, 120, 160, seed=3)``
(the inputs of ``tests/test_torch_port_cuda.py``'s preset test) five ways:
through every kernel, through every plain version, through the plain
gathers with kernel K6, through the kernel gathers with the plain K6, and
through the plain versions in float64.  Prints one JSON object with

- ``pose``: the largest |dR| and |dt| of each float32 forward against the
  plain one and against the float64 one;
- ``occ_flips``: for each forward, the ICP residual calls (level,
  iteration) whose occlusion mask differs from the plain forward's, with
  the number of pixels that differ;
- ``k6``: for each K6 call of the kernel forward, the largest error of
  K6's and of the plain version's JtJ and JtR against float64 sums of the
  same inputs, relative to the largest float64 entry.

    python3 scripts/torch_rgb_icp_gap.py            # on the card (nvcc)
    python3 scripts/torch_rgb_icp_gap.py --cpu --size 2 32 40   # rehearsal
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch  # noqa: E402
from deep_prob_feature_track_torch.ops.kernels import jtj  # noqa: E402
from deep_prob_feature_track_torch.solvers import icp, jacobians  # noqa: E402

LEVELS = (3, 2, 1, 0)
ITERS = 3


def forward(batch, dev, plain, swap_k6=False, dtype=torch.float32):
    """The pose, and the occlusion masks of every ICP residual call.  With
    ``swap_k6`` the normal equations take the other route than the
    gathers: kernel K6 under ``plain``, its plain version otherwise."""
    masks, k6_args = [], []
    saved = (icp.icp_residuals_inverse, jacobians.fused_jtj_jtr, jacobians.jtj_jtr_ref)

    def residuals(*a, **k):
        out = saved[0](*a, **k)
        masks.append(out[2].clone())
        return out

    def kernel_k6(*a, **k):
        k6_args.append([t.clone() for t in a])
        return saved[1](*a, **k)

    icp.icp_residuals_inverse = residuals
    jacobians.fused_jtj_jtr = jtj.jtj_jtr_ref if swap_k6 and not plain else kernel_k6
    jacobians.jtj_jtr_ref = saved[1] if swap_k6 and plain else saved[2]
    try:
        net = build_tracker("RGB+ICP", device=dev, plain_kernels=plain).to(dtype)
        with torch.inference_mode():
            R, t = net(*[a.to(dtype) for a in batch])
    finally:
        icp.icp_residuals_inverse, jacobians.fused_jtj_jtr, jacobians.jtj_jtr_ref = saved
    return (R.double().cpu(), t.double().cpu()), masks, k6_args


def _diff(a, b):
    return [float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max())]


def _flips(masks, ref):
    return [{"level": LEVELS[i // ITERS], "iteration": i % ITERS, "pixels": int((m ^ r).sum())}
            for i, (m, r) in enumerate(zip(masks, ref)) if (m ^ r).any()]


def _k6_errors(args):
    """K6 and the plain version against float64 sums of the same inputs."""
    rows = []
    for i, a in enumerate(args):
        ref = jtj.jtj_jtr_ref(*[t.double() for t in a])
        row = {"level": LEVELS[i // ITERS], "iteration": i % ITERS}
        for name, fn in (("k6", jtj.fused_jtj_jtr), ("plain", jtj.jtj_jtr_ref)):
            got = fn(*a)
            for k, g, r in zip(("jtj", "jtr"), got, ref):
                row[f"{name}_{k}"] = float((g.double() - r).abs().max() / r.abs().max())
        rows.append(row)
    return rows


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="rehearse on the CPU")
    p.add_argument("--size", type=int, nargs=3, default=(8, 120, 160), metavar=("B", "H", "W"))
    args = p.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = example_batch(*args.size, seed=3, device=dev)

    runs = {
        "kernels": forward(batch, dev, plain=False),
        "plain": forward(batch, dev, plain=True),
        "plain_gathers_k6": forward(batch, dev, plain=True, swap_k6=True),
        "kernel_gathers_plain_k6": forward(batch, dev, plain=False, swap_k6=True),
    }
    pose64, masks64, _ = forward(batch, dev, plain=True, dtype=torch.float64)
    plain_pose, plain_masks, _ = runs["plain"]
    out = {
        "pose": {name: {"vs_plain": _diff(pose, plain_pose), "vs_float64": _diff(pose, pose64)}
                 for name, (pose, _, _) in runs.items()},
        "occ_flips": {name: _flips(masks, plain_masks) for name, (_, masks, _) in runs.items()},
        "occ_flips_float64": _flips(masks64, plain_masks),
        "k6": _k6_errors(runs["kernels"][2]),
        "kernels_vs_plain_gathers_k6": _diff(runs["kernels"][0], runs["plain_gathers_k6"][0]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
