"""Batched two-view tracking service (HTTP + npz payloads).

Counterpart of ``deep_prob_feature_track_tpu/apps/serve.py``: requests are
queued, micro-batched up to ``--max_batch`` (or flushed after
``--batch_timeout_ms``), padded to that batch size with copies of the last
request (which leaves the batch-global depth and sigma reductions
unchanged) and run as ONE forward on the device; per-request poses return
as npz.

    POST /track   body: npz with color0/color1 [3,H,W] float32 in [0,1],
                  depth0/depth1 [1,H,W] float32 meters, calib [4]
                  -> npz with R [3,3], t [3]
    GET  /healthz -> {"status": "ok", ...}

Run: python -m deep_prob_feature_track_torch.apps.serve --preset feature \
        --checkpoint ckpt.pt --port 8642

``--preset`` takes ``feature``, ``feature_icp``, ``DeepIC``, ``RGB``, ``ICP``
or ``'RGB+ICP'`` (quoted in a shell).  A checkpoint is a ``torch.save`` of the
tracker's ``state_dict`` or a training state (``training/checkpoints.py``);
without one the weights come from a seeded init
(the classical presets ``RGB``, ``ICP`` and ``RGB+ICP`` have no weights).  Float32 convolutions and matmuls
run without TF32, so the encoder matches its float32 reference.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..device import resolve_device, set_float32_policy

_KEYS = ("color0", "color1", "depth0", "depth1", "calib")


class TrackingService:
    """Micro-batching dispatcher around a fixed-batch forward."""

    def __init__(self, forward_fn, device, max_batch: int = 8,
                 batch_timeout_ms: float = 5.0, expected_hw=None):
        self.forward_fn = forward_fn
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.expected_hw = expected_hw  # (H, W) the service was built for
        self.batch_timeout = batch_timeout_ms / 1e3
        self.requests: "queue.Queue" = queue.Queue()
        self.n_served = 0
        self.n_batches = 0
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.worker.start()

    def submit(self, item: dict, timeout: float = 120.0) -> dict:
        """Blocking request: returns {'R': [3,3], 't': [3]}.

        Raises ValueError for shape mismatches and RuntimeError if the
        dispatcher failed or timed out.
        """
        if self.expected_hw is not None:
            H, W = self.expected_hw
            for key, c in (("color0", 3), ("color1", 3), ("depth0", 1), ("depth1", 1)):
                if item[key].shape != (c, H, W):
                    raise ValueError(
                        f"payload {key} shape {item[key].shape} != served ({c},{H},{W})")
        if item["calib"].shape != (4,):
            raise ValueError(f"payload calib shape {item['calib'].shape} != (4,)")
        done = threading.Event()
        slot = {"item": item, "done": done, "out": None, "error": None}
        self.requests.put(slot)
        if not done.wait(timeout):
            raise RuntimeError("tracking request timed out")
        if slot["error"] is not None:
            raise RuntimeError(slot["error"])
        return slot["out"]

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        self.worker.join(timeout)

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.requests.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.batch_timeout
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.requests.get(timeout=remaining))
                except queue.Empty:
                    break

            n = len(batch)
            try:
                pad = self.max_batch - n
                args = [
                    torch.from_numpy(np.stack(
                        [s["item"][k] for s in batch] + [batch[-1]["item"][k]] * pad
                    ).astype(np.float32)).to(self.device)
                    for k in _KEYS
                ]
                R, t = self.forward_fn(*args)
                R = R.cpu().numpy()
                t = t.cpu().numpy()
                for i, slot in enumerate(batch):
                    slot["out"] = {"R": R[i], "t": t[i]}
                    slot["done"].set()
                self.n_served += n
                self.n_batches += 1
            except Exception as e:  # fail the batch, keep the worker alive
                for slot in batch:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    slot["done"].set()


def make_handler(service: TrackingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, e: Exception):
            self._reply(code, json.dumps({"error": str(e)}).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                self.send_response(404)
                self.end_headers()
                return
            body = json.dumps({"status": "ok", "served": service.n_served,
                               "batches": service.n_batches}).encode()
            self._reply(200, body, "application/json")

        def do_POST(self):
            if self.path != "/track":
                self.send_response(404)
                self.end_headers()
                return
            try:
                length = int(self.headers["Content-Length"])
                data = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
                item = {k: np.asarray(data[k], np.float32) for k in _KEYS}
            except (ValueError, KeyError, TypeError, OSError) as e:  # malformed payload
                self._error(400, e)
                return
            try:
                out = service.submit(item)
            except ValueError as e:
                self._error(400, e)
                return
            except RuntimeError as e:
                self._error(500, e)
                return
            buf = io.BytesIO()
            np.savez(buf, R=out["R"], t=out["t"])
            self._reply(200, buf.getvalue(), "application/octet-stream")

    return Handler


def build_tracker(preset: str = "feature", checkpoint: str = "", device="cuda",
                  seed: int = 0, plain_kernels: bool = False, overrides=()):
    """The eval-mode tracker on ``device``, from a checkpoint or a seeded init.

    :param plain_kernels: run the CUDA kernels' plain PyTorch versions
    :param overrides: ``key=value`` strings applied to the preset's
        config (``models/presets.py::apply_overrides``), e.g.
        ``["direction=forward"]`` for the U_FC track
    """
    from ..models.presets import apply_overrides, get_preset
    from ..models.tracker import LeastSquareTracking
    from ..training.checkpoints import restore_variables, tracker_weights

    dev = resolve_device(device)
    set_float32_policy()
    net = LeastSquareTracking(apply_overrides(get_preset(preset), overrides),
                              plain_kernels=plain_kernels)
    if checkpoint:
        net.load_state_dict(tracker_weights(restore_variables(checkpoint)), strict=True)
    else:
        net.reset_parameters(seed)
    return net.to(dev)


def example_batch(B: int, H: int, W: int, seed: int = 0, device="cpu"):
    """Random inputs of the served shape: colors in [0,1], depths in
    [0.5, 1.5] m, the 120x160 TUM intrinsics scaled to HxW (TUM's own
    ``[525, 525, 319.5, 239.5]`` at 480x640)."""
    rng = np.random.RandomState(seed)
    sx, sy = W / 160, H / 120
    arrays = (
        rng.rand(B, 3, H, W), rng.rand(B, 3, H, W),
        rng.rand(B, 1, H, W) + 0.5, rng.rand(B, 1, H, W) + 0.5,
        np.tile([[131.25 * sx, 131.25 * sy, 79.875 * sx, 59.875 * sy]], (B, 1)),
    )
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


def build_service(preset: str, checkpoint: str, max_batch: int, H=120, W=160,
                  device="cuda", seed: int = 0, batch_timeout_ms: float = 5.0, overrides=()):
    net = build_tracker(preset, checkpoint, device, seed, overrides=overrides)
    dev = resolve_device(device)

    def forward(*args):
        with torch.inference_mode():
            return net(*args)

    # warm up (kernel build, cuDNN algorithm choice) before serving traffic
    R, _ = forward(*example_batch(max_batch, H, W, device=dev))
    R.cpu()
    return TrackingService(forward, dev, max_batch=max_batch,
                           batch_timeout_ms=batch_timeout_ms, expected_hw=(H, W))


def main(argv=None):
    p = argparse.ArgumentParser(description="Two-view tracking service")
    p.add_argument("--preset", default="feature")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--batch_timeout_ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    service = build_service(args.preset, args.checkpoint, args.max_batch,
                            device=args.device, seed=args.seed,
                            batch_timeout_ms=args.batch_timeout_ms)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"[serve] tracking service on {args.host}:{args.port} "
          f"(max_batch={args.max_batch}, device={args.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.stop()


if __name__ == "__main__":
    raise SystemExit(main())
