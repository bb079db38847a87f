"""Peak memory, step time and launches of the 640x480 training step under
the tracker's training memory modes, and the largest batch that fits one
card in one microbatch.

    python3 scripts/remat_memory.py [--configs feature,DeepIC,...]
        [--batches 4,8] [--modes none,...] [--largest none,remat_encoder,all]
        [--out remat_memory.json]

On the card (it exits 1 without one), each configuration of ``CONFIGS``
named in ``--configs`` (default ``feature``, the paper model) at its
published widths with seeded random weights, on the seeded B=8 batch of
``training/train.py::synthetic_batch`` scenes at 640x480, repeated to the
batch a step takes:

- at each B of ``--batches``, for each mode set of ``--modes`` (default
  every entry of ``MODES``: no mode, each of ``remat_gn``,
  ``remat_encoder`` and ``bf16_residuals`` alone, ``remat_encoder`` with
  each of the other two, and all three): ``torch.cuda.max_memory_allocated``
  over one step (after a warm-up step) and what the step added to the
  memory allocated before it; the events time of a step (median of 3, after
  the warm-up); the kernels' launches a step, counted by their wrappers;
- for each mode set of ``--largest``, the largest B whose step fits in one
  microbatch: B doubles from 8 until a step runs out of memory, then
  bisects to 1; each trial is one step of a fresh state on the seeded B=8
  batch repeated to B, and an out-of-memory error ends the trial (a
  measurement, not a failure).  Each trial's peak is kept; then the step
  at the largest trial B that leaves ``HEADROOM_GB`` of the card free is
  measured as at B=4 and 8 (samples/s at a batch one card fits).

A configuration that raises anything else is recorded with its error and
the next one runs.  Prints one JSON line (and writes it to ``--out`` where
given), headed by the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

H, W = 480, 640
SEED = 3
HEADROOM_GB = 10.0
MODES = {
    "none": {},
    "remat_gn": {"remat_gn": True},
    "remat_encoder": {"remat_encoder": True},
    "bf16_residuals": {"bf16_residuals": True},
    "remat_encoder+remat_gn": {"remat_encoder": True, "remat_gn": True},
    "remat_encoder+bf16_residuals": {"remat_encoder": True, "bf16_residuals": True},
    "all": {"remat_gn": True, "remat_encoder": True, "bf16_residuals": True},
}
# name -> (preset, overrides): the paper model, its ICP variant, DeepIC and
# the forward-compositional track with the learned MultiScale2w estimator
CONFIGS = {
    "feature": ("feature", ()),
    "feature_icp": ("feature_icp", ()),
    "DeepIC": ("DeepIC", ()),
    "U_FC MultiScale2w": ("feature", ("direction=forward", "mest_type=MultiScale2w",
                                      "train_init_pose=false")),
}


def log(msg: str) -> None:
    print(f"[remat_memory] {msg}", flush=True)


def make_state(torch, dev, config, modes):
    from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as T

    preset, overrides = CONFIGS[config]
    net = LeastSquareTracking(apply_overrides(get_preset(preset), list(overrides)), **modes)
    cfg = T.TrainConfig()
    state = T.create_train_state(net, cfg, seed=1, device=dev)
    return state, T.make_train_step(cfg, steps_per_epoch=100)


def batch_of(torch, dev, b):
    """The seeded B=8 scenes repeated to ``b`` samples, on the card."""
    from deep_prob_feature_track_torch.training import train as T

    base = T.synthetic_batch(8, H, W, seed=SEED, device=dev)
    reps = -(-b // 8)
    return {k: torch.cat([v] * reps)[:b] for k, v in base.items()}


def measure(torch, dev, config, modes, b):
    """One warm-up step, then one step's peak memory, the memory the step
    added to what was allocated before it, its launches, and the median
    events time of three more steps."""
    from deep_prob_feature_track_torch.ops import kernels as K

    state, step = make_state(torch, dev, config, modes)
    batch = batch_of(torch, dev, b)
    step(state, batch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: n for k, n in K.LAUNCHES.items() if n}
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    loss = metrics["loss"].item()
    if not math.isfinite(loss):
        raise AssertionError(f"B={b} {modes}: non-finite loss {loss}")
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"peak_gb": peak / 1e9, "step_added_gb": (peak - before) / 1e9,
            "step_ms": sorted(times)[1], "samples_per_s": b / sorted(times)[1] * 1e3,
            "launches": launches, "loss": loss}


def fits(torch, dev, config, modes, b):
    """Whether one step at ``b`` runs; its peak memory in GB, or None."""
    state = step = batch = None
    try:
        state, step = make_state(torch, dev, config, modes)
        batch = batch_of(torch, dev, b)
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError, or a library's
        if not isinstance(e, torch.cuda.OutOfMemoryError) and "ALLOC_FAILED" not in str(e):
            raise
        peak = None
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def largest_batch(torch, dev, config, modes, label):
    """The largest B that one step fits, and every trial's peak GB."""
    trials = {}
    lo, hi = 0, 8
    while True:
        peak = fits(torch, dev, config, modes, hi)
        trials[hi] = peak
        log(f"{label}: B={hi} {'out of memory' if peak is None else f'peak {peak:.2f} GB'}")
        if peak is None:
            break
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        peak = fits(torch, dev, config, modes, mid)
        trials[mid] = peak
        log(f"{label}: B={mid} {'out of memory' if peak is None else f'peak {peak:.2f} GB'}")
        lo, hi = (mid, hi) if peak is not None else (lo, mid)
    return {"largest_b": lo, "trials": {str(k): v for k, v in sorted(trials.items())}}


def survey(torch, dev, config, args, card_gb):
    """The ladder and the largest batches of one configuration."""
    out = {"ladder": {}, "largest": {}}
    for b in args.batches:
        for name in args.modes:
            r = measure(torch, dev, config, MODES[name], b)
            out["ladder"][f"B={b} {name}"] = r
            log(f"{config} B={b} {name}: peak {r['peak_gb']:.3f} GB (the step adds "
                f"{r['step_added_gb']:.3f}), {r['step_ms']:.2f} ms a step "
                f"({r['samples_per_s']:.2f} samples/s), launches {r['launches']}")
    for name in args.largest:
        label = f"{config} {name}"
        r = largest_batch(torch, dev, config, MODES[name], label)
        fit = max(int(b) for b, peak in r["trials"].items()
                  if peak is not None and peak <= card_gb - HEADROOM_GB)
        r["headroom_b"], r["headroom_step"] = fit, measure(torch, dev, config, MODES[name], fit)
        out["largest"][name] = r
        log(f"{label}: the largest one-microbatch B is {r['largest_b']}; at B={fit} (peak "
            f"{r['headroom_step']['peak_gb']:.2f} of {card_gb:.2f} GB) "
            f"{r['headroom_step']['step_ms']:.1f} ms a step, "
            f"{r['headroom_step']['samples_per_s']:.2f} samples/s")
    return out


def _names(raw, known):
    names = [n for n in raw.split(",") if n]
    for n in names:
        if n not in known:
            raise SystemExit(f"remat_memory: unknown name {n!r}; known: {', '.join(known)}")
    return names


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default="feature", help="comma-separated names of CONFIGS")
    p.add_argument("--batches", default="4,8", help="comma-separated batches of the ladder")
    p.add_argument("--modes", default=",".join(MODES),
                   help="comma-separated mode sets (MODES) of the ladder")
    p.add_argument("--largest", default="none,remat_encoder,all",
                   help="comma-separated mode sets whose largest batch is searched")
    p.add_argument("--out", default="", help="also write the JSON line to this file")
    args = p.parse_args(argv)
    configs = _names(args.configs, CONFIGS)
    args.modes, args.largest = _names(args.modes, MODES), _names(args.largest, MODES)
    args.batches = [int(b) for b in args.batches.split(",") if b]
    import torch

    if not torch.cuda.is_available():
        print("remat_memory: no CUDA device", file=sys.stderr)
        return 1
    from deep_prob_feature_track_torch.device import set_float32_policy
    from deep_prob_feature_track_torch.ops.kernels import loader

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log(f"device {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}")
    set_float32_policy()
    t0 = time.monotonic()
    loader.build()
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    out = {"card": smi, "hw": [H, W], "configs": {}}
    for config in configs:
        try:
            out["configs"][config] = survey(torch, dev, config, args, card_gb)
        except Exception as e:  # recorded; the next configuration runs
            log(f"{config}: {type(e).__name__}: {e}")
            out["configs"][config] = {"error": f"{type(e).__name__}: {e}"}
            gc.collect()
            torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t0
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
