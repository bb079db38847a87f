#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is non-zero):

1. the card's name and power limit;
2. build the CUDA kernels from the sources in the checkout (one ``nvcc``
   per source, all started together);
3. K1 ``gather_twohot`` against its plain version at the four pyramid
   shapes of the 120x160 B=8 forward (C=10, coordinates out of range and on
   the border): bit-exact is expected, the limit is max-abs <= 1e-6;
4. K6 ``fused_jtj_jtr`` against its plain version at the same four shapes
   (C=8): rtol 1e-5, atol 1e-5 of the largest entry;
5. K2 ``gather_twohot_grads`` and K3 ``splat_twohot`` against their plain
   versions at the four pyramid shapes of the 120x160 B=64 training step
   (C=10): K2's ``out`` bit-exact, its gx/gy within 1e-6 of the largest
   entry; K3 (float atomics) within 1e-5 of the largest entry;
6. K4 ``gather_tiles`` (B=8, 480x640) and K5 ``gather_tiles_grads`` (B=4,
   480x640 and 240x320) against their plain versions and against K1 / K2
   on the same inputs, at C=10 and C=17, on smooth small-motion coordinates
   (every tile stages its box in shared memory) and on the same with
   samples teleported across the plane (one launch takes both paths):
   ``out`` bit-exact, gx/gy within 1e-6 of the largest entry;
7. serve: ``build_service("feature", "", max_batch=8)`` at 120x160 on the
   card, 12 requests from threads and one HTTP ``POST /track``; with the
   launch counts reset just before and read just after, K1 and K6 must
   have run 12 times per served batch and K2-K5 not at all.  Every R
   must be orthonormal and every t finite, and one batch through the
   kernels, through their plain versions on the card and on the CPU must
   agree within atol 1e-4;
8. train: the feature preset's train state on the card at 120x160, B=64,
   a seeded synthetic batch, 3 steps; with the counts reset before and read
   after each step, K2, K3 and K6 must have run 12 times and K1, K4, K5 not
   at all, and the loss and gradient norm must be finite.  One loss and
   backward through the kernels and through their plain versions on the
   card must agree: the loss within 1e-5 relative, each gradient leaf within
   5e-3 of its largest entry (the envelope of 12 chained Gauss-Newton
   solves).  The step is timed with the kernels and with the plain versions
   and profiled;
9. serve at 480x640 as in 7: per batch K4 3 times (level 0), K1 9 times
   (levels 1-3), K6 12 times, K2, K3 and K5 not at all; the kernel and
   plain forwards agree at B=8, the kernel and CPU forwards at B=2;
10. train at 480x640, B=4 as in 8: per step K5 6 times (levels 0-1), K2 6
   times (levels 2-3), K3 and K6 12 times, K1 and K4 not at all; kernels
   against plain within the same limits; timed and profiled;
11. the share of tiles that staged on the 480x640 synthetic scene's own
   level-0 (and level-1) warps;
12. time the forwards and each kernel at each level (CUDA events around
   back-to-back calls after warm-up, and the kernels' own device time:
   events around calls queued behind a sleep kernel, so no host launch gap
   falls between them; operands warm in L2 where they fit, as in the
   Gauss-Newton loop that reuses them), beside the plain version, one PyTorch library
   call computing the same function where there is one, and the least time
   the card could take (bytes moved over the memory rate, or flops over the
   f32 rate); K2 and K3 at the B=64 training shapes; K4 and K5 at the
   480x640 shapes beside K1 and K2 on the same inputs;
13. profile one B=8 forward at 120x160 and at 480x640 (``torch.profiler``):
   device busy time, the span from its first to its last kernel, the idle
   share of that span, and device time by kernel name.

The last lines are a JSON ``kernels`` record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or without the port package beside it.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

B, H, W = 8, 120, 160
B_TRAIN = 64  # the paper's training batch
LEVELS = ((120, 160), (60, 80), (30, 40), (15, 20))
H_VGA, W_VGA = 480, 640
VGA_LEVELS = ((480, 640), (240, 320), (120, 160), (60, 80))
B_VGA_TRAIN = 4  # the JAX package's 640x480 step without gradient accumulation
C_WARP, C_RES, C_FULL = 10, 8, 17  # C_FULL: the warp operand before sigma-slim
N_REQUESTS = 12
TRAIN_STEPS = 3
# batch seeds whose two forwards (kernels, plain) mask the same pixels: on
# some seeds K6's last-bit differences flip one pixel of a discrete mask
# (occlusion, sigma min/max), which moves the gradient by more than rounding
TRAIN_SEED = 5
VGA_TRAIN_SEED = 3
GRAD_ENVELOPE = 5e-3
SLEEP_CYCLES = 100_000_000  # ~50 ms of device sleep while device_ms queues its calls
N_CPU_VGA = 2  # the CPU forward at 480x640 takes this many requests of the batch
KEYS = ("color0", "color1", "depth0", "depth1", "calib")
# published peaks (NVIDIA data sheets): device-memory bytes/s, f32 flop/s
# outside the tensor cores; first matching substring of the card's name
PEAKS = (("H200", 4.8e12, 67e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H100", 3.35e12, 67e12))

TPU_SOURCES = {
    "gather_twohot": "deep_prob_feature_track_tpu/ops/pallas/gather.py:204",
    "gather_twohot_grads": "deep_prob_feature_track_tpu/ops/pallas/gather.py:234",
    "splat_twohot": "deep_prob_feature_track_tpu/ops/pallas/gather.py:283",
    "gather_tiles": "deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py:177",
    "gather_tiles_grads": "deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py:177",
    "fused_jtj_jtr": "deep_prob_feature_track_tpu/ops/pallas/jtj.py:26",
}


def counts(**n):
    """Launch counts of every kernel, 0 where not given."""
    return {k: n.get(k, 0) for k in TPU_SOURCES}


# per served batch and per training step
SERVE_LAUNCHES = counts(gather_twohot=12, fused_jtj_jtr=12)
TRAIN_LAUNCHES = counts(gather_twohot_grads=12, splat_twohot=12, fused_jtj_jtr=12)
VGA_SERVE_LAUNCHES = counts(gather_tiles=3, gather_twohot=9, fused_jtj_jtr=12)
VGA_TRAIN_LAUNCHES = counts(gather_tiles_grads=6, gather_twohot_grads=6, splat_twohot=12,
                            fused_jtj_jtr=12)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def peaks(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peak rates for {name!r}")


def bound(nbytes, nflops, bw, flops):
    """The least time the card could take, in ms, and what bounds it: the
    bytes moved over the memory rate or the flops over the f32 rate."""
    return {"bound_ms": 1e3 * max(nbytes / bw, nflops / flops),
            "bound_by": "bytes" if nbytes / bw >= nflops / flops else "operations"}


def time_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time per call of ``fn``: CUDA events around ``reps``
    back-to-back calls that the host queues while the card runs a sleep
    kernel, so the card runs them with no host launch gaps between them.
    Raises if the host took longer to queue them than the sleep lasted."""
    fn()
    torch.cuda.synchronize()
    queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    queued.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = queued.elapsed_time(start)
    if not host_ms < sleep_ms:
        raise RuntimeError(f"queueing {reps} calls took {host_ms:.3f} ms, longer than the "
                           f"{sleep_ms:.3f} ms sleep: the card waited for the host")
    return start.elapsed_time(end) / reps


def gather_inputs(torch, dev, h, w, seed, b=B):
    from deep_prob_feature_track_torch.geometry.warp import _corner_weights

    g = torch.Generator().manual_seed(seed)
    F = torch.randn(b, h, w, C_WARP, generator=g)
    u = torch.rand(b, 1, h, w, generator=g) * (w + 6) - 3
    v = torch.rand(b, 1, h, w, generator=g) * (h + 6) - 3
    u[:, 0, 0, :4] = torch.tensor([0.0, w - 1.0, w - 2.0, 3.0])
    v[:, 0, 0, :4] = torch.tensor([h - 1.0, 0.0, 5.0, h - 2.0])
    u, v = u.to(dev), v.to(dev)
    return (F.to(dev), *_corner_weights(F.shape, u, v)), (u, v)


def jtj_inputs(torch, dev, hw, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = ((B, C_RES, hw),) * 3 + ((B, hw, 6),) * 2
    return [torch.randn(*s, generator=g).to(dev) for s in shapes]


def phase_kernels(torch, dev):
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {"gather_twohot": 0.0, "fused_jtj_jtr": 0.0}
    for i, (h, w) in enumerate(LEVELS):
        args, _ = gather_inputs(torch, dev, h, w, seed=i)
        out = K.gather_twohot_cuda(*args)
        ref = K.gather_twohot_ref(*args)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        log(f"K1 gather_twohot level {i} [{B},{C_WARP},{h * w}]: max|kernel - plain| = {e:.3e}")
        if not e <= 1e-6:
            raise AssertionError(f"gather_twohot disagrees with its plain version: {e}")
        err["gather_twohot"] = max(err["gather_twohot"], e)

        args = jtj_inputs(torch, dev, h * w, seed=10 + i)
        jtj, jtr = K.fused_jtj_jtr_cuda(*args, sign=-1.0)
        jtj_r, jtr_r = K.jtj_jtr_ref(*args, sign=-1.0)
        torch.cuda.synchronize()
        for got, ref in ((jtj, jtj_r), (jtr, jtr_r)):
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
        e = max((jtj - jtj_r).abs().max().item(), (jtr - jtr_r).abs().max().item())
        rel = e / jtj_r.abs().max().item()
        log(f"K6 fused_jtj_jtr level {i} [{B},{C_RES},{h * w}]: max|kernel - plain| = "
            f"{e:.3e} ({rel:.2e} of the largest entry)")
        err["fused_jtj_jtr"] = max(err["fused_jtj_jtr"], e)
    return err


def splat_cotangent(torch, dev, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B_TRAIN, C_WARP, h * w, generator=g).to(dev)


def phase_grads_kernels(torch, dev):
    from deep_prob_feature_track_torch.ops import kernels as K

    err = {"gather_twohot_grads": 0.0, "splat_twohot": 0.0}
    for i, (h, w) in enumerate(LEVELS):
        args, _ = gather_inputs(torch, dev, h, w, seed=20 + i, b=B_TRAIN)
        got = K.gather_twohot_grads_cuda(*args)
        ref = K.gather_twohot_grads_ref(*args)
        torch.cuda.synchronize()
        e_out = (got[0] - ref[0]).abs().max().item()
        e_grads = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
        top = max(r.abs().max().item() for r in ref[1:])
        log(f"K2 gather_twohot_grads level {i} [{B_TRAIN},{C_WARP},{h * w}]: max|out - plain| "
            f"= {e_out:.3e}, max|gx,gy - plain| = {e_grads:.3e} ({e_grads / top:.2e} of "
            f"the largest entry)")
        if e_out != 0.0:
            raise AssertionError(f"gather_twohot_grads out is not bit-exact: {e_out}")
        if not e_grads <= 1e-6 * top:
            raise AssertionError(f"gather_twohot_grads gx/gy disagree: {e_grads}")
        err["gather_twohot_grads"] = max(err["gather_twohot_grads"], e_grads)

        g = splat_cotangent(torch, dev, h, w, seed=30 + i)
        got = K.splat_twohot_cuda(g, *args[1:], h, w)
        ref = K.splat_twohot_ref(g, *args[1:], h, w)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        log(f"K3 splat_twohot level {i} [{B_TRAIN},{h},{w},{C_WARP}]: max|kernel - plain| = "
            f"{e:.3e} ({e / top:.2e} of the largest entry {top:.3e})")
        if not e <= 1e-5 * top:
            raise AssertionError(f"splat_twohot disagrees with its plain version: {e}")
        err["splat_twohot"] = max(err["splat_twohot"], e)
    return err


def tile_inputs(torch, dev, b, h, w, c, seed, teleport=False):
    """A plane F [b,h,w,c] and the corner maps [b,h,w] of smooth sub-pixel
    flow (a tracker near convergence: every tile's box fits in shared
    memory), or of the same with 64 samples per image moved half the plane
    away (their tiles take the global path).  Also returns (u, v)."""
    from deep_prob_feature_track_torch.geometry.warp import _corner_weights

    g = torch.Generator().manual_seed(seed)
    F = torch.randn(b, h, w, c, generator=g)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    phase = torch.rand(b, 1, 1, 1, generator=g) * 3
    u = (xx + 0.8 * torch.sin(yy / 9.0 + phase) + 0.3).contiguous()
    v = (yy + 0.8 * torch.cos(xx / 11.0 + phase) + 0.2).contiguous()
    if teleport:
        idx = torch.randint(0, h * w, (b, 64), generator=g)
        for m, size in ((u, w), (v, h)):
            flat = m.view(b, -1)
            flat.scatter_(1, idx, (flat.gather(1, idx) + size / 2) % (size - 1))
    u, v = u.to(dev), v.to(dev)
    maps = [t.reshape(b, h, w) for t in _corner_weights((b, h, w, c), u, v)]
    return F.to(dev), maps, (u, v)


# (kernel, batch, level of VGA_LEVELS) as the 480x640 paths launch them
TILE_CASES = (("gather_tiles", B, 0), ("gather_tiles_grads", B_VGA_TRAIN, 0),
              ("gather_tiles_grads", B_VGA_TRAIN, 1))


def phase_tiles_kernels(torch, dev):
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.ops.kernels.tiles import staged_share

    err = {"gather_tiles": 0.0, "gather_tiles_grads": 0.0}
    for i, (kname, b, level) in enumerate(TILE_CASES):
        h, w = VGA_LEVELS[level]
        for c in (C_WARP, C_FULL):
            for teleport in (False, True):
                F, maps, _ = tile_inputs(torch, dev, b, h, w, c, seed=40 + i, teleport=teleport)
                flat = [m.reshape(b, -1) for m in maps]
                share = staged_share(maps[0], maps[2], h, w, c)
                if kname == "gather_tiles":
                    got = (K.gather_tiles_cuda(F, *maps),)
                    ref = (K.gather_tiles_ref(F, *maps),)
                    full = (K.gather_twohot_cuda(F, *flat),)
                else:
                    got = K.gather_tiles_grads_cuda(F, *maps)
                    ref = K.gather_tiles_grads_ref(F, *maps)
                    full = K.gather_twohot_grads_cuda(F, *flat)
                torch.cuda.synchronize()
                e_out = (got[0] - ref[0]).abs().max().item()
                e_full = max((a - r).abs().max().item() for a, r in zip(got, full))
                e_grads, top = 0.0, 1.0
                if len(got) == 3:
                    e_grads = max((a - r).abs().max().item() for a, r in zip(got[1:], ref[1:]))
                    top = max(r.abs().max().item() for r in ref[1:])
                log(f"{kname} level {level} [{b},{c},{h * w}], "
                    f"{'teleported' if teleport else 'smooth'} coordinates, staged share "
                    f"{share:.4f}: max|out - plain| = {e_out:.3e}, max|gx,gy - plain| = "
                    f"{e_grads:.3e} ({e_grads / top:.2e} of the largest entry), "
                    f"max|kernel - {'K2' if len(got) == 3 else 'K1'}| = {e_full:.3e}")
                if e_out != 0.0 or e_full != 0.0:
                    raise AssertionError(f"{kname} out is not bit-exact: {e_out}, {e_full}")
                if not e_grads <= 1e-6 * top:
                    raise AssertionError(f"{kname} gx/gy disagree: {e_grads}")
                if not (0.0 < share < 1.0 if teleport else share == 1.0):
                    raise AssertionError(f"{kname}: staged share {share} does not exercise the "
                                         "path these coordinates were made for")
                err[kname] = max(err[kname], e_grads if len(got) == 3 else e_out)
    return err


def _payload(item) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **item)
    return buf.getvalue()


def request_items(n: int, h: int, w: int):
    from deep_prob_feature_track_torch.apps.serve import example_batch

    batch = [t.numpy() for t in example_batch(n, h, w, seed=1)]
    return [{k: a[i] for k, a in zip(KEYS, batch)} for i in range(n)]


def phase_serve(torch, dev, h, w, expected):
    """Serve 12 requests from threads and one HTTP request at h x w; the
    launch counts must be ``expected`` per served batch."""
    from deep_prob_feature_track_torch.apps.serve import build_service, make_handler
    from deep_prob_feature_track_torch.ops import kernels as K

    service = build_service("feature", "", max_batch=B, H=h, W=w, device=dev)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        items = request_items(N_REQUESTS + 1, h, w)
        results = [None] * N_REQUESTS
        errors = []

        def call(i):
            try:
                results[i] = service.submit(items[i])
            except Exception as e:  # recorded and raised below
                errors.append(f"request {i}: {e!r}")

        n0 = service.n_batches
        K.reset_launches()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(N_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/track"
        req = urllib.request.Request(url, data=_payload(items[-1]), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            http_out = np.load(io.BytesIO(r.read()))
            results.append({"R": http_out["R"], "t": http_out["t"]})
        launches = dict(K.LAUNCHES)
        batches = service.n_batches - n0
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        server.join(10)

    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"requests failed: {errors}")
    log(f"served {len(results)} requests at {h}x{w} ({N_REQUESTS} from threads + 1 HTTP) "
        f"in {batches} batches; launches {launches}")
    if batches < 2:
        raise AssertionError("expected at least two batches")
    for name, n in launches.items():
        if n != expected[name] * batches:
            raise AssertionError(f"{name} launched {n} times in {batches} batches, "
                                 f"expected {expected[name] * batches}")
    for i, out in enumerate(results):
        R, t = out["R"], out["t"]
        orth = np.abs(R.T @ R - np.eye(3)).max()
        if R.shape != (3, 3) or t.shape != (3,) or not orth < 1e-4 or not np.isfinite(t).all():
            raise AssertionError(f"request {i}: bad pose (|R^T R - I| = {orth}, t = {t})")
    return launches, items[:B]


def phase_agree(torch, dev, items, n_cpu):
    """The forward of ``items`` through the kernels against their plain
    versions on the card; the forward of the first ``n_cpu`` of them through
    the kernels against the CPU forward."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker

    def pose(batch_items, device, plain=False):
        batch = [torch.from_numpy(np.stack([it[k] for it in batch_items])).to(device)
                 for k in KEYS]
        net = build_tracker("feature", device=device, plain_kernels=plain)
        with torch.inference_mode():
            R, t = net(*batch)
        return R.cpu().numpy(), t.cpu().numpy()

    kernels = pose(items, dev)
    pairs = [("plain", kernels, pose(items, dev, plain=True))]
    few = kernels if n_cpu == len(items) else pose(items[:n_cpu], dev)
    pairs.append(("cpu", few, pose(items[:n_cpu], torch.device("cpu"))))
    h, w = items[0]["color0"].shape[1:]
    for label, (R0, t0), (R, t) in pairs:
        dR, dt = np.abs(R - R0).max(), np.abs(t - t0).max()
        log(f"B={len(R)} {h}x{w} forward, kernels vs {label}: max|dR| = {dR:.3e}, "
            f"max|dt| = {dt:.3e}")
        if not (dR <= 1e-4 and dt <= 1e-4):
            raise AssertionError(f"kernel forward disagrees with the {label} forward")


def _train_state(torch, dev, plain=False):
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as T

    cfg = T.TrainConfig()
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=plain)
    return cfg, T.create_train_state(net, cfg, seed=1, device=dev)


def _loss_and_grads(torch, dev, batch, plain):
    from deep_prob_feature_track_torch.training import train as T

    cfg, state = _train_state(torch, dev, plain)
    loss = T.compute_loss(state.net, cfg, batch)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in state.net.named_parameters()}


def phase_train(torch, dev, b, h, w, seed, expected):
    """Three steps at b x h x w, with the launch counts ``expected`` per
    step; kernels against plain versions; step time, memory, profile."""
    from deep_prob_feature_track_torch.ops import kernels as K
    from deep_prob_feature_track_torch.training import train as T

    batch = T.synthetic_batch(b, h, w, seed=seed, device=dev)
    cfg, state = _train_state(torch, dev)
    step = T.make_train_step(cfg, steps_per_epoch=100)
    launches = {k: 0 for k in K.LAUNCHES}
    losses = []
    for i in range(TRAIN_STEPS):
        K.reset_launches()
        state, metrics = step(state, batch)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        n = dict(K.LAUNCHES)
        log(f"B={b} {h}x{w} train step {i}: loss {loss:.6f}, grad norm {norm:.6f}, "
            f"launches {n}")
        if not (np.isfinite(loss) and np.isfinite(norm)):
            raise AssertionError(f"train step {i}: non-finite loss {loss} or grad norm {norm}")
        if n != expected:
            raise AssertionError(f"train step {i} launched {n}, expected {expected}")
        for k, c in n.items():
            launches[k] += c
        losses.append(loss)

    # kernels twice (K3's atomics and cuDNN reorder sums from run to run),
    # then the plain versions
    (loss_k, grads_k), (_, grads_k2), (loss_p, grads_p) = (
        _loss_and_grads(torch, dev, batch, plain) for plain in (False, False, True))

    def worst_leaf(grads, ref):
        """max over leaves of |grads - ref| / max|ref|, and its leaf"""
        ratios = [(((grads[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item(), k)
                  for k, g in ref.items()]
        if not all(np.isfinite(r) for r, _ in ratios):
            raise AssertionError("a gradient leaf is not finite")
        return max(ratios)

    spread, spread_key = worst_leaf(grads_k2, grads_k)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_key = worst_leaf(grads_k, grads_p)
    log(f"B={b} {h}x{w} train loss, kernels vs plain: {loss_k:.6f} vs {loss_p:.6f} "
        f"(relative {rel_loss:.2e}); worst gradient leaf {worst_key}: {worst:.2e} of its "
        f"largest entry (kernels vs kernels: {spread:.2e}, {spread_key})")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"train loss through the kernels disagrees: {rel_loss}")
    if not worst <= GRAD_ENVELOPE:
        raise AssertionError(f"gradient leaf {worst_key} outside the envelope: {worst}")

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda: step(state, batch), reps=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, plain_state = _train_state(torch, dev, plain=True)
    step_plain_ms = time_ms(torch, lambda: step(plain_state, batch), reps=5, warmup=2)
    log(f"B={b} {h}x{w} train step: {step_ms:.3f} ms with the kernels "
        f"({b / step_ms * 1e3:.1f} samples/s, peak memory {peak_gb:.2f} GB), "
        f"{step_plain_ms:.3f} ms with their plain versions")
    return {
        "launches": launches, "losses": losses, "loss_rel_err": rel_loss,
        "worst_grad_leaf": [worst_key, worst], "run_to_run_grad_leaf": [spread_key, spread],
        "step_ms": step_ms,
        "step_plain_ms": step_plain_ms, "peak_memory_gb": peak_gb,
        "profile": profile(torch, lambda: step(state, batch), f"B={b} {h}x{w} train step"),
    }


def phase_scene_share(torch, dev):
    """The share of tiles that staged in K4's and K5's launches on the
    480x640 synthetic scene: the forward's own level-0 warps (and level 1 in
    training), recorded from the warp's kernel calls."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker
    from deep_prob_feature_track_torch.geometry import warp
    from deep_prob_feature_track_torch.ops.kernels.tiles import staged_share
    from deep_prob_feature_track_torch.training import train as T

    shares = {"gather_tiles": [], "gather_tiles_grads": []}
    kernels = {k: getattr(warp, k) for k in shares}

    def recorder(name):
        def call(F, v0, dv, u0, du):
            shares[name].append(((v0.shape[1], v0.shape[2]), staged_share(v0, u0, *F.shape[1:])))
            return kernels[name](F, v0, dv, u0, du)
        return call

    batch = T.synthetic_batch(B, H_VGA, W_VGA, seed=VGA_TRAIN_SEED, device=dev)
    args = [batch[k] for k in KEYS]
    for name in shares:
        setattr(warp, name, recorder(name))
    net = build_tracker("feature", device=dev)
    with torch.inference_mode():
        net(*args)
    net.train()(*[a[:B_VGA_TRAIN] for a in args])
    for name, fn in kernels.items():
        setattr(warp, name, fn)
    for name, calls in shares.items():
        log(f"{name} on the 480x640 synthetic scene: staged share per call "
            + ", ".join(f"{h}x{w} {s:.4f}" for (h, w), s in calls))
    return {k: [s for _, s in v] for k, v in shares.items()}


def phase_time(torch, dev, name):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch
    from deep_prob_feature_track_torch.ops import kernels as K

    bw, flops = peaks(name)
    net = build_tracker("feature", device=dev)
    plain = build_tracker("feature", device=dev, plain_kernels=True)
    batch = example_batch(B, H, W, seed=2, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: net(*batch), reps=20, warmup=3)
        fwd_plain_ms = time_ms(torch, lambda: plain(*batch), reps=20, warmup=3)
    log(f"B=8 120x160 forward: {fwd_ms:.3f} ms with the kernels, "
        f"{fwd_plain_ms:.3f} ms with their plain versions")

    levels = []
    for i, (h, w) in enumerate(LEVELS):
        n = h * w
        args, (u, v) = gather_inputs(torch, dev, h, w, seed=i)
        F = args[0]
        grid = torch.stack([u.reshape(B, 1, n) * (2.0 / (w - 1)) - 1,
                            v.reshape(B, 1, n) * (2.0 / (h - 1)) - 1], dim=-1)
        F_nchw = F.permute(0, 3, 1, 2).contiguous()
        gbytes = 4 * (F.numel() + 4 * B * n + B * C_WARP * n)
        gflops = B * n * (2 + 11 * C_WARP)
        k1 = {
            "ms": time_ms(torch, lambda: K.gather_twohot_cuda(*args)),
            "device_ms": device_ms(torch, lambda: K.gather_twohot_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: K.gather_twohot_ref(*args)),
            "library_ms": time_ms(torch, lambda: torch.nn.functional.grid_sample(
                F_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
            **bound(gbytes, gflops, bw, flops),
        }
        jargs = jtj_inputs(torch, dev, n, seed=10 + i)
        jbytes = 4 * (3 * B * C_RES * n + 2 * B * n * 6 + B * 42)
        jflops = B * n * (10 * C_RES + 144)
        k6 = {
            "ms": time_ms(torch, lambda: K.fused_jtj_jtr_cuda(*jargs)),
            "device_ms": device_ms(torch, lambda: K.fused_jtj_jtr_cuda(*jargs)),
            "plain_ms": time_ms(torch, lambda: K.jtj_jtr_ref(*jargs)),
            "library_ms": None,
            **bound(jbytes, jflops, bw, flops),
        }
        levels.append({"level": i, "hw": [h, w], "gather_twohot": k1, "fused_jtj_jtr": k6})
        log(f"level {i} {h}x{w}: K1 {k1['ms']:.4f} ms, device {k1['device_ms']:.4f} "
            f"(plain {k1['plain_ms']:.4f}, grid_sample {k1['library_ms']:.4f}, "
            f"bound {k1['bound_ms']:.4f}); K6 {k6['ms']:.4f} ms, device "
            f"{k6['device_ms']:.4f} (plain {k6['plain_ms']:.4f}, bound {k6['bound_ms']:.4f})")
    return {"forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms, "levels": levels}


def phase_time_grads(torch, dev, name):
    from deep_prob_feature_track_torch.ops import kernels as K

    bw, flops = peaks(name)
    levels = []
    for i, (h, w) in enumerate(LEVELS):
        n = h * w
        args, (u, v) = gather_inputs(torch, dev, h, w, seed=20 + i, b=B_TRAIN)
        g = splat_cotangent(torch, dev, h, w, seed=30 + i)
        planes = B_TRAIN * n * C_WARP  # operand plane = each [B,C,N] map, in floats
        k2_bytes = 4 * (planes + 4 * B_TRAIN * n + 3 * planes)
        k2_flops = B_TRAIN * n * (2 + 17 * C_WARP)
        k2 = {
            "ms": time_ms(torch, lambda: K.gather_twohot_grads_cuda(*args)),
            "device_ms": device_ms(torch, lambda: K.gather_twohot_grads_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: K.gather_twohot_grads_ref(*args)),
            "library_ms": None,  # no single PyTorch call returns the value and both maps
            **bound(k2_bytes, k2_flops, bw, flops),
        }
        # the library's operand cotangent of grid_sample(border, align_corners=True)
        grid = torch.stack([u.reshape(B_TRAIN, 1, n) * (2.0 / (w - 1)) - 1,
                            v.reshape(B_TRAIN, 1, n) * (2.0 / (h - 1)) - 1], dim=-1)
        F_nchw = args[0].permute(0, 3, 1, 2).contiguous()
        g4 = g.reshape(B_TRAIN, C_WARP, 1, n)
        k3_bytes = 4 * (planes + 4 * B_TRAIN * n + planes)
        k3_flops = B_TRAIN * n * (2 + 12 * C_WARP)
        k3 = {
            "ms": time_ms(torch, lambda: K.splat_twohot_cuda(g, *args[1:], h, w)),
            "device_ms": device_ms(torch, lambda: K.splat_twohot_cuda(g, *args[1:], h, w)),
            "plain_ms": time_ms(torch, lambda: K.splat_twohot_ref(g, *args[1:], h, w)),
            "library_ms": time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
                g4, F_nchw, grid, 0, 1, True, [True, False])),
            **bound(k3_bytes, k3_flops, bw, flops),
        }
        levels.append({"level": i, "hw": [h, w], "gather_twohot_grads": k2, "splat_twohot": k3})
        log(f"level {i} {h}x{w} B={B_TRAIN}: K2 {k2['ms']:.4f} ms, device "
            f"{k2['device_ms']:.4f} (plain {k2['plain_ms']:.4f}, bound {k2['bound_ms']:.4f}); "
            f"K3 {k3['ms']:.4f} ms, device {k3['device_ms']:.4f} (plain {k3['plain_ms']:.4f}, "
            f"grid_sampler_2d_backward {k3['library_ms']:.4f}, bound {k3['bound_ms']:.4f})")
    return levels




def phase_time_tiles(torch, dev, name):
    """K4 and K5 at the 480x640 shapes on smooth coordinates, beside their
    plain versions, K1 / K2 on the same inputs (the same function over the
    whole plane) and, for K4, ``grid_sample``."""
    from deep_prob_feature_track_torch.ops import kernels as K

    bw, flops = peaks(name)
    levels = []
    for i, (kname, b, level) in enumerate(TILE_CASES):
        h, w = VGA_LEVELS[level]
        n = h * w
        F, maps, (u, v) = tile_inputs(torch, dev, b, h, w, C_WARP, seed=60 + i)
        flat = [m.reshape(b, -1) for m in maps]
        planes = b * n * C_WARP  # floats of the operand plane and of each output
        if kname == "gather_tiles":
            kern, plain, full = K.gather_tiles_cuda, K.gather_tiles_ref, K.gather_twohot_cuda
            nbytes, nflops = 4 * (planes + 4 * b * n + planes), b * n * (2 + 11 * C_WARP)
            grid = torch.stack([u.reshape(b, 1, n) * (2.0 / (w - 1)) - 1,
                                v.reshape(b, 1, n) * (2.0 / (h - 1)) - 1], dim=-1)
            F_nchw = F.permute(0, 3, 1, 2).contiguous()
            library = time_ms(torch, lambda: torch.nn.functional.grid_sample(
                F_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True))
        else:
            kern, plain = K.gather_tiles_grads_cuda, K.gather_tiles_grads_ref
            full = K.gather_twohot_grads_cuda
            nbytes, nflops = 4 * (planes + 4 * b * n + 3 * planes), b * n * (2 + 17 * C_WARP)
            library = None  # no single PyTorch call returns the value and both maps
        row = {
            "ms": time_ms(torch, lambda: kern(F, *maps)),
            "device_ms": device_ms(torch, lambda: kern(F, *maps)),
            "plain_ms": time_ms(torch, lambda: plain(F, *maps)),
            "library_ms": library,
            **bound(nbytes, nflops, bw, flops),
            "full_plane_ms": time_ms(torch, lambda: full(F, *flat)),
            "full_plane_device_ms": device_ms(torch, lambda: full(F, *flat)),
        }
        levels.append({"kernel": kname, "level": level, "b": b, "hw": [h, w], **row})
        log(f"{kname} level {level} B={b} {h}x{w}: {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} (plain {row['plain_ms']:.4f}, "
            f"{'K1' if library is not None else 'K2'} on the same inputs "
            f"{row['full_plane_ms']:.4f}, device {row['full_plane_device_ms']:.4f}, "
            f"grid_sample {'-' if library is None else f'{library:.4f}'}, "
            f"bound {row['bound_ms']:.4f})")
    return levels


def phase_forward(torch, dev, h, w):
    """The B=8 forward at h x w, with the kernels and with their plain
    versions, and one profiled forward."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    net = build_tracker("feature", device=dev)
    plain = build_tracker("feature", device=dev, plain_kernels=True)
    batch = example_batch(B, h, w, seed=2, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: net(*batch), reps=10, warmup=2)
        fwd_plain_ms = time_ms(torch, lambda: plain(*batch), reps=10, warmup=2)
        log(f"B={B} {h}x{w} forward: {fwd_ms:.3f} ms with the kernels "
            f"({B / fwd_ms * 1e3:.1f} frame pairs/s), {fwd_plain_ms:.3f} ms with their "
            f"plain versions")
        return {"forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
                "profile": profile(torch, lambda: net(*batch), f"B={B} {h}x{w} forward")}


def profile(torch, fn, label):
    """Device busy time, span, idle share, launch count and the top kernels
    of one call of ``fn`` after three warm-up calls (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {
        "device_busy_ms": busy, "device_span_ms": span, "idle_share": 1.0 - busy / span,
        "kernel_launches": len(kernels),
        "top": [{"name": k[:80], "ms": ms, "count": n} for k, (ms, n) in top],
    }
    log(f"profile of one {label}: device busy {busy:.3f} ms over a {span:.3f} ms span "
        f"(idle share {out['idle_share']:.3f}), {len(kernels)} kernel launches")
    return out


def phase_profile(torch, dev):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    net = build_tracker("feature", device=dev)
    batch = example_batch(B, H, W, seed=2, device=dev)
    with torch.inference_mode():
        return profile(torch, lambda: net(*batch), "B=8 forward")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        from deep_prob_feature_track_torch.device import set_float32_policy
        from deep_prob_feature_track_torch.ops.kernels import loader
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    set_float32_policy()
    kernels = run(torch, loader, dev, name, smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(torch, loader, dev, name, smi):
    """Every phase on ``dev``; prints the measurements as one JSON line and
    returns the ``kernels`` record."""
    t_start = time.monotonic()
    t0 = time.monotonic()
    paths = loader.build()
    log(f"built {sorted(paths)} in {time.monotonic() - t0:.1f} s")
    for source in sorted(paths):
        for line in (loader.BUILD_DIR / f"{source}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {source}: {line.strip()}")

    errors = phase_kernels(torch, dev)
    errors.update(phase_grads_kernels(torch, dev))
    errors.update(phase_tiles_kernels(torch, dev))
    launches, items = phase_serve(torch, dev, H, W, SERVE_LAUNCHES)
    phase_agree(torch, dev, items, n_cpu=B)
    train = phase_train(torch, dev, B_TRAIN, H, W, TRAIN_SEED, TRAIN_LAUNCHES)
    vga_launches, vga_items = phase_serve(torch, dev, H_VGA, W_VGA, VGA_SERVE_LAUNCHES)
    phase_agree(torch, dev, vga_items, n_cpu=N_CPU_VGA)
    vga_train = phase_train(torch, dev, B_VGA_TRAIN, H_VGA, W_VGA, VGA_TRAIN_SEED,
                            VGA_TRAIN_LAUNCHES)
    scene_shares = phase_scene_share(torch, dev)
    timing = phase_time(torch, dev, name)
    grads_levels = phase_time_grads(torch, dev, name)
    tiles_levels = phase_time_tiles(torch, dev, name)
    timing["profile"] = phase_profile(torch, dev)
    vga_forward = phase_forward(torch, dev, H_VGA, W_VGA)
    print(json.dumps({"timing": timing, "grads_levels": grads_levels, "train": train,
                      "vga": {"forward": vga_forward, "train": vga_train,
                              "tiles_levels": tiles_levels, "scene_staged_share": scene_shares,
                              "serve_launches": vga_launches},
                      "card": smi}), flush=True)

    # K1 and K6 as the 120x160 serve path launched them, K2 and K3 as the
    # 120x160 train path did; K4 as the 480x640 serve path, K5 as the 480x640
    # train path did
    level0 = {**timing["levels"][0], **grads_levels[0],
              **{row["kernel"]: row for row in tiles_levels if row["level"] == 0}}
    launches.update({k: train["launches"][k] for k in ("gather_twohot_grads", "splat_twohot")})
    launches["gather_tiles"] = vga_launches["gather_tiles"]
    launches["gather_tiles_grads"] = vga_train["launches"]["gather_tiles_grads"]
    kernels = []
    for kname in TPU_SOURCES:
        k = level0[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"deep_prob_feature_track_torch/ops/kernels/csrc/{loader.SOURCES[kname]}.cu",
            "replaces": TPU_SOURCES[kname],
            "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    log(f"done in {time.monotonic() - t_start:.1f} s")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
