"""Time K3 (``splat_twohot``) of one tree on the card and split its device
time by kernel.

For the port package of ``--tree`` (default: this checkout), on the inputs
of ``chip_smoke.py``'s time phases: level 0 of the 120x160 B=64 training
step at C=10 on random, smooth, teleported and off-plane coordinates, at
C=11 and C=28 on random and smooth ones, and level 0 of the 640x480 B=4 step
(smooth, C=10).  Each case is first held to the plain twin bit for bit,
then timed: CUDA events around back-to-back calls (``ms``), the device time
of calls queued behind a sleep kernel (``device_ms``), and the device time
of each kernel and memset of one call, from a ``torch.profiler`` trace of
10 calls (``split_us``, ``chip_smoke.kernel_split_us``).  Then the 120x160
B=64 and 640x480 B=4 ``feature`` train steps: events ms, and the share of
one step's device time that K3's kernels take.  Prints one JSON line; run it once per tree to compare a
commit with its parent on one card::

    python3 scripts/k3_timing.py --tree archive/parent

The helpers come from this checkout's ``chip_smoke.py``; the package from
``--tree``.  Needs a CUDA card; builds the tree's kernels first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K3's device kernels, by name: this tree's and the fixed-point design before it
K3_KERNELS = ("splat_", "finite_max_kernel", "convert_kernel")


def k3_kernel(name: str) -> bool:
    return any(k in name for k in K3_KERNELS)


def step_share(torch, cs, dev, b, h, w, seed):
    """The ``feature`` train step at b x h x w: events ms (5 steps after 2
    of warm-up) and K3's share of one profiled step's device time."""
    from deep_prob_feature_track_torch.training import train as T

    batch = T.synthetic_batch(b, h, w, seed=seed, device=dev)
    cfg, state = cs._train_state(torch, dev)
    step = T.make_train_step(cfg, steps_per_epoch=100)
    ms = cs.time_ms(torch, lambda: step(state, batch), reps=5, warmup=2)
    kernels = cs.traced_kernels(torch, lambda: step(state, batch), warmup=1)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k3 = sum(e.time_range.elapsed_us() for e in kernels if k3_kernel(e.name)) / 1e3
    return {"events_ms": ms, "busy_ms": busy, "k3_ms": k3,
            "k3_share": k3 / busy if busy else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=HERE,
                   help="the checkout whose port package runs (default: this one)")
    p.add_argument("--no_steps", action="store_true", help="time the kernel alone")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deep_prob_feature_track_torch.device import set_float32_policy
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels import loader

    if not torch.cuda.is_available():
        print("k3_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    set_float32_policy()
    t0 = time.monotonic()
    cs.build_kernels(loader)
    bw, flops = cs.peaks(name)
    h, w = cs.LEVELS[0]
    cases = [(coords, cs.C_WARP) for coords in cs.COORDS]
    cases += [(coords, c) for c in (11, cs.C_UFC) for coords in ("random", "smooth")]
    rows = []
    for coords, c in cases + [("vga smooth", cs.C_WARP)]:
        if coords == "vga smooth":
            b, (hh, ww) = cs.B_VGA_TRAIN, cs.VGA_LEVELS[0]
            _, maps, _ = cs.flat_inputs(torch, dev, b, hh, ww, c, 70, "smooth")
        elif coords == "random":
            b, hh, ww = cs.B_TRAIN, h, w
            args_, _ = cs.gather_inputs(torch, dev, h, w, seed=20, b=b)
            maps = list(args_[1:])
        else:
            b, hh, ww = cs.B_TRAIN, h, w
            _, maps, _ = cs.flat_inputs(torch, dev, b, h, w, c, 30, coords)
        n = hh * ww
        g = torch.randn(b, c, n, generator=torch.Generator().manual_seed(31)).to(dev)
        cs.check_splat(torch, K.splat_twohot_cuda(g, *maps, hh, ww),
                       K.splat_twohot_ref(g, *maps, hh, ww), f"{coords} C={c}")
        call = lambda: K.splat_twohot_cuda(g, *maps, hh, ww)  # noqa: E731
        row = {"coords": coords, "b": b, "hw": [hh, ww], "c": c,
               "ms": cs.time_ms(torch, call, windows=5), "device_ms": cs.device_ms(torch, call),
               **cs.bound(4 * (2 * b * n * c + 4 * b * n), b * n * (2 + 12 * c), bw, flops)}
        row["split_us"] = cs.kernel_split_us(torch, call)
        rows.append(row)
        cs.log(f"K3 {coords} B={b} {hh}x{ww} C={c}: {row['ms'] * 1e3:.1f} µs events, "
               f"{row['device_ms'] * 1e3:.1f} µs device, bound {row['bound_ms'] * 1e3:.2f}; "
               f"split {row['split_us']}")
    out = {"tree": os.path.abspath(args.tree), "card": smi, "k3": rows}
    if not args.no_steps:
        out["steps"] = {
            f"feature B={cs.B_TRAIN} {h}x{w}": step_share(torch, cs, dev, cs.B_TRAIN, h, w,
                                                           cs.TRAIN_SEED),
            f"feature B={cs.B_VGA_TRAIN} {cs.H_VGA}x{cs.W_VGA}": step_share(
                torch, cs, dev, cs.B_VGA_TRAIN, cs.H_VGA, cs.W_VGA, cs.VGA_TRAIN_SEED)}
        cs.log(f"steps: {out['steps']}")
    out["seconds"] = time.monotonic() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
