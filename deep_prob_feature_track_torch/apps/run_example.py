"""Minimal inference example: track consecutive frames from PNG folders.

Counterpart of ``deep_prob_feature_track_tpu/apps/run_example.py``: a
``SimpleLoader`` over colour and depth folders, each pair resized to
120x160 with the intrinsics rescaled, one tracker forward a pair on the
card (``--device cpu`` for the CPU), the pose (R, t) printed::

    python -m deep_prob_feature_track_torch.apps.run_example \
        --color_dir <dir>/rgb --depth_dir <dir>/depth \
        [--preset feature|DeepIC|RGB|ICP|...] [--checkpoint ckpt.pt]

The colour is resized by align-corners bilinear sampling
(``ops/image.py::bilinear_resize_align``: kernel K1 on the card), the depth
by nearest sampling.  The intrinsics are scaled as the image is, as in the
JAX package (the original script swaps the two scales).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def resize_batch(batch, resizeH: int = 120, resizeW: int = 160, device="cuda"):
    """A numpy batch resized to ``resizeH x resizeW`` on ``device`` (the
    card unless ``"cpu"`` is asked for), with rescaled intrinsics: bilinear
    (align corners) colour, nearest depth at rows ``int(i * (H / resizeH))``
    computed in float32, as the JAX function computes them.

    :return: ``(color0, color1, depth0, depth1, K)`` tensors
    """
    from ..device import resolve_device
    from ..geometry.warp import resize_K
    from ..ops.image import bilinear_resize_align

    device = resolve_device(device)
    c0, c1, d0, d1, K = (torch.from_numpy(np.asarray(batch[k])).to(device)
                         for k in ("color0", "color1", "depth0", "depth1", "calib"))
    H, W = c0.shape[-2:]
    C0 = bilinear_resize_align(c0, resizeH, resizeW)
    C1 = bilinear_resize_align(c1, resizeH, resizeW)

    def index(n_out, n_in):
        f = np.arange(n_out, dtype=np.float32) * np.float32(n_in / n_out)
        return torch.from_numpy(f.astype(np.int64)).to(device)

    ys, xs = index(resizeH, H), index(resizeW, W)

    def nearest(x):
        return x[:, :, ys][:, :, :, xs]

    return C0, C1, nearest(d0), nearest(d1), resize_K(K, resizeW / W, resizeH / H)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run the tracker on a folder of frames")
    parser.add_argument("--color_dir", required=True)
    parser.add_argument("--depth_dir", required=True)
    parser.add_argument("--intrinsic", default="525.0,525.0,319.5,239.5",
                        help="pin-hole intrinsics fx,fy,cx,cy")
    parser.add_argument("--preset", default="feature")
    parser.add_argument("--checkpoint", default="",
                        help="a tracker state_dict or a training state (.pt)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..data.pipeline import BatchLoader
    from ..data.simple import SimpleLoader
    from ..device import resolve_device
    from .serve import build_tracker

    device = resolve_device(args.device)
    K = [float(x) for x in args.intrinsic.split(",")]
    loader = BatchLoader(SimpleLoader(args.color_dir, args.depth_dir, K), batch_size=1,
                         shuffle=False, prefetch=1)
    if not args.checkpoint:
        print("[run_example] no checkpoint given: using randomly initialized weights")
    net = build_tracker(args.preset, args.checkpoint, device, seed=args.seed)
    for idx, batch in enumerate(loader):
        with torch.inference_mode():
            R, t = net(*resize_batch(batch, device=device))
        print(f"pair {idx}:")
        print("Rotation:")
        print(R.cpu().numpy())
        print("translation:")
        print(t.cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
