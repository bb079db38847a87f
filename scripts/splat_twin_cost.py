"""What K3's fixed-point plain version costs on the CPU against a float32
``index_add_`` sum of the same products (the plain version before it was
made to sum in fixed point), at the CPU tests' shapes.

    python3 scripts/splat_twin_cost.py [--threads 2] [--reps 15]

Prints one JSON line: for each shape [B,H,W,C], the best of ``--reps``
calls of each, in ms, and their ratio.  CPU only; no card, no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SHAPES = ((2, 16, 20, 10), (2, 32, 40, 10), (2, 64, 80, 10), (4, 64, 80, 28), (2, 96, 448, 10))


def float_sum(torch, g, v0, dv, u0, du, H, W):
    B, C, N = g.shape
    idx = v0.long().clamp(0, H - 2) * W + u0.long().clamp(0, W - 2)
    idx = (idx + torch.arange(B)[:, None] * (H * W)).reshape(-1)
    g_nc = g.transpose(1, 2).reshape(B * N, C)
    du, dv = du.reshape(B * N, 1), dv.reshape(B * N, 1)
    out = torch.zeros((B * H * W, C), dtype=g.dtype)
    for offset, w in ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)), (W, (1 - du) * dv),
                      (W + 1, du * dv)):
        out.index_add_(0, idx + offset, g_nc * w)
    return out.reshape(B, H, W, C)


def best_ms(fn, reps):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--reps", type=int, default=15)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from deep_prob_feature_track_torch.geometry.warp import _corner_weights
    from deep_prob_feature_track_torch.ops.kernels import splat_twohot_ref

    torch.set_num_threads(args.threads)
    rows = []
    for B, H, W, C in SHAPES:
        gen = torch.Generator().manual_seed(0)
        u = torch.rand(B, 1, H, W, generator=gen) * (W + 2) - 1
        v = torch.rand(B, 1, H, W, generator=gen) * (H + 2) - 1
        a = _corner_weights((B, H, W, C), u, v)
        g = torch.randn(B, C, H * W, generator=gen)
        fixed = best_ms(lambda: splat_twohot_ref(g, *a, H, W), args.reps)
        floats = best_ms(lambda: float_sum(torch, g, *a, H, W), args.reps)
        rows.append({"shape": [B, H, W, C], "fixed_ms": fixed, "float_ms": floats,
                     "ratio": fixed / floats})
    print(json.dumps({"threads": args.threads, "torch": torch.__version__, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
