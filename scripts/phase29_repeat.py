"""Repeat ``chip_smoke.py``'s phase 29 several times in one process and
report how far the runs lie apart.

Phase 29 trains 2 steps through the train CLI at 120x160 B=64, resumes for
one more, and holds the evaluate CLI's poses on the resumed checkpoint
within 1e-4 of ``evaluate_two_view`` through the plain kernels.  This
script runs that phase ``--runs`` times from one tree (its
``chip_smoke.py`` and its package), on one TUM-format sequence, and prints
one JSON line with, for each run: the CLI's largest pose gap against plain
at each keyframe, whether the phase's own checks passed (a failed check is
counted, with its message), and the largest difference of the run's
checkpoints after 2 and 3 steps from the first run's.  It also runs K3
(``splat_twohot``) ``--k3_repeats`` times on one input at level 0's shape
and counts the results whose bits differ from the first.  Run it once per
tree to compare a commit with its parent on one card::

    python3 scripts/phase29_repeat.py --tree /path/to/checkout --runs 3

Needs a CUDA card; builds the tree's kernels first.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="the checkout whose chip_smoke.py and package run (default: this one)")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--k3_repeats", type=int, default=5)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels import loader
    from deep_prob_feature_track_torch.device import set_float32_policy
    from deep_prob_feature_track_torch.training import checkpoints

    if not torch.cuda.is_available():
        print("phase29_repeat: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    set_float32_policy()
    cs.build_kernels(loader)

    lines = []
    logged = cs.log

    def capture(msg):
        lines.append(msg)
        logged(msg)

    cs.log = capture
    gap = re.compile(r"evaluate CLI 0\.25 \S*keyframe_(\d+): CLI against plain: "
                     r"max\|dR\| (\S+), max\|dt\| (\S+)")
    top = tempfile.mkdtemp(prefix="phase29_")
    runs, first = [], None
    try:
        seq, _ = cs.phase_tum_sequence(top)
        for i in range(args.runs):
            workdir = os.path.join(top, f"run{i}")
            os.makedirs(workdir)
            del lines[:]
            t0 = time.monotonic()
            try:
                cs.phase_cli_train(torch, dev, seq, workdir)
                error = None
            except AssertionError as e:  # the phase's own check: counted, not hidden
                error = str(e)
            logs = os.path.join(workdir, "logs")
            (logdir,) = [os.path.join(logs, d) for d in os.listdir(logs)
                         if d.endswith(f"_batch_{cs.B_TRAIN}")]
            ckpts = {n: checkpoints.restore_variables(
                os.path.join(logdir, f"checkpoint_epoch{n}.pt"))["net"] for n in (1, 3)}
            if first is None:
                first = ckpts
            apart = {f"step{2 if n == 1 else 3}_weights_vs_run0": max(
                (a.double() - b.double()).abs().max().item() if a.is_floating_point()
                else float((a != b).any()) for a, b in zip(ckpts[n].values(), first[n].values()))
                for n in (1, 3)}
            gaps = {}
            for m in (gap.search(x) for x in lines):
                if m:
                    gaps[f"keyframe_{m.group(1)}"] = [float(m.group(2)), float(m.group(3))]
            runs.append({"ok": error is None, "error": error, "plain_gap_dR_dt": gaps, **apart,
                         "s": time.monotonic() - t0})
            # (each run's data root stays: the sequence's cache names the first one's paths)

        h, w = cs.LEVELS[0]
        kargs, _ = cs.gather_inputs(torch, dev, h, w, seed=20, b=cs.B_TRAIN)
        g = cs.splat_cotangent(torch, dev, h, w, seed=30)
        outs = [K.splat_twohot_cuda(g, *kargs[1:], h, w) for _ in range(args.k3_repeats)]
        torch.cuda.synchronize()
        k3 = {"shape": [cs.B_TRAIN, h, w, cs.C_WARP], "repeats": args.k3_repeats,
              "differ_from_first": sum(not torch.equal(o, outs[0]) for o in outs[1:]),
              "max_abs_apart": max((o - outs[0]).abs().max().item() for o in outs)}
    finally:
        cs.log = logged
        shutil.rmtree(top, ignore_errors=True)
    print(json.dumps({"tree": tree, "card": smi, "runs": runs, "k3": k3}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
