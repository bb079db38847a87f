"""Find what changes the bits of a training step on the card from run to run.

    python3 scripts/determinism_audit.py [--mesh]

1. In a child process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``:
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` over one
   ``feature`` step at 120x160 B=64 and one at 640x480 B=4, the PyTorch
   operations it flags as nondeterministic (the port's own kernels, bound
   through ``ctypes``, are not seen by it; a warning raised in the
   backward's thread may reach only the child's stderr, whose flagged
   lines are kept too); then, with ``use_deterministic_algorithms(True)``,
   ``chip_smoke.step_twice`` at both sizes: the tensors that still differ,
   or the error of the first operation without a deterministic version.
2. ``chip_smoke.step_twice`` at both sizes (two steps from the seeded state
   on the seeded batch, run twice), with ``torch.backends.cudnn.
   deterministic`` False and True (``set_float32_policy``, which the train
   state's creation calls, sets it True; the False runs patch it back):
   the gradient leaves, parameters, BatchNorm statistics and Adam moments
   whose bits differ between the two runs, and the step's events ms under
   each setting.
3. With ``--mesh``: ``chip_smoke.phase_two_ranks`` (phase 53's two gloo
   ranks on the card and the one-process reference) run twice; both runs'
   losses of both steps, on the ranks and in one process.

Prints one JSON line beside the card's name and power limit.  Needs a
CUDA card; builds the kernels first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import warnings

SIZES = (("120x160 B=64", "B_TRAIN", "H", "W", "TRAIN_SEED"),
         ("640x480 B=4", "B_VGA_TRAIN", "H_VGA", "W_VGA", "VGA_TRAIN_SEED"))


def _sizes(cs):
    return [(label, getattr(cs, b), getattr(cs, h), getattr(cs, w), getattr(cs, seed))
            for label, b, h, w, seed in SIZES]


def diagnose(torch, cs, dev):
    """The messages of ``use_deterministic_algorithms(True, warn_only=True)``
    over one step at each size, and ``step_twice`` at each size under
    ``use_deterministic_algorithms(True)``."""
    from deep_prob_feature_track_torch.training import train as T

    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"flagged": {}, "strict": {}}
    for label, b, h, w, seed in _sizes(cs):
        batch = T.synthetic_batch(b, h, w, seed=seed, device=dev)
        cfg, state = cs._train_state(torch, dev)
        step = T.make_train_step(cfg, steps_per_epoch=100)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, batch)
            torch.cuda.synchronize()
        out["flagged"][label] = sorted({str(x.message).splitlines()[0] for x in caught})
    torch.use_deterministic_algorithms(True)
    for label, b, h, w, seed in _sizes(cs):
        try:
            r = cs.step_twice(torch, dev, b, h, w, seed)
            out["strict"][label] = {"losses": r["losses"], "differ": sorted(r["differ"])}
        except RuntimeError as e:
            out["strict"][label] = {"error": str(e).splitlines()[0]}
    return out


def step_ms(torch, cs, dev, b, h, w, seed):
    from deep_prob_feature_track_torch.training import train as T

    batch = T.synthetic_batch(b, h, w, seed=seed, device=dev)
    cfg, state = cs._train_state(torch, dev)
    step = T.make_train_step(cfg, steps_per_epoch=100)
    return cs.time_ms(torch, lambda: step(state, batch), reps=5, warmup=2, windows=3)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mesh", action="store_true", help="also run phases 53-54 twice")
    p.add_argument("--diagnose", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    import chip_smoke as cs
    from deep_prob_feature_track_torch.device import set_float32_policy
    from deep_prob_feature_track_torch.ops.kernels import loader

    if not torch.cuda.is_available():
        print("determinism_audit: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    set_float32_policy()
    cs.build_kernels(loader)
    if args.diagnose:  # the child of step 1
        print(json.dumps(diagnose(torch, cs, dev)), flush=True)
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--diagnose"],
                           env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
                           capture_output=True, text=True, timeout=900)
    if child.returncode:
        raise RuntimeError(f"the diagnostic run failed:\n{child.stdout[-3000:]}"
                           f"{child.stderr[-3000:]}")
    out = {"card": smi, **json.loads(child.stdout.strip().splitlines()[-1]),
           "child_stderr_flags": sorted({line.strip() for line in child.stderr.splitlines()
                                         if "determinis" in line})}
    cs.log(f"use_deterministic_algorithms: flags {out['flagged']}, in the child's stderr "
           f"{out['child_stderr_flags']}; strict runs {out['strict']}")

    from deep_prob_feature_track_torch.training import train as T

    policy = T.set_float32_policy
    out["runs"] = {}
    for deterministic in (False, True):
        def set_policy(d=deterministic):
            policy()
            torch.backends.cudnn.deterministic = d

        T.set_float32_policy = set_policy
        for label, b, h, w, seed in _sizes(cs):
            r = cs.step_twice(torch, dev, b, h, w, seed)
            r["step_ms"] = step_ms(torch, cs, dev, b, h, w, seed)
            key = f"{label}, cudnn.deterministic={deterministic}"
            out["runs"][key] = r
            cs.log(f"{key}: losses {r['losses']}; {len(r['differ'])} of {r['tensors']} "
                   f"tensors differ (first: {sorted(r['differ'])[:5]}); {r['step_ms']:.3f} ms "
                   f"a step")
    T.set_float32_policy = policy
    set_float32_policy()

    if args.mesh:
        top = tempfile.mkdtemp(prefix="audit_mesh_")
        try:
            seq = os.path.join(top, "seq")
            cs.write_tum_sequence(seq, n=cs.DENSE_FRAMES)
            mesh = []
            for i in range(2):
                workdir = os.path.join(top, f"run{i}")
                os.makedirs(workdir)
                r = cs.phase_two_ranks(torch, dev, workdir, seq)["train"]
                mesh.append({"rank_losses": r["losses"], "one_process_losses": r["ref_losses"]})
            out["mesh"] = {"runs": mesh, "same": mesh[0] == mesh[1]}
            cs.log(f"phases 53-54 run twice: {out['mesh']}")
        finally:
            shutil.rmtree(top, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
