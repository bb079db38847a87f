"""Object-motion study on MovingObjects3D: warp the second frame into the
first under each pair's object pose and draw the masked residual.

Counterpart of ``deep_prob_feature_track_tpu/apps/warping_objects.py``::

    python -m deep_prob_feature_track_torch.apps.warping_objects \
        --data_root /path/to/mo3d --object boat --num_pairs 8 [--gt_pose]

For the first ``--num_pairs`` pairs of the object's test sequences (keyframe
gap 1, ``image_resize`` 0.25) the pose is the ground truth (``--gt_pose``)
or the tracker's estimate from both frames and their object masks
(``--preset``, ``--checkpoint``: a ``.pt`` tracker state or training state
of the port; a seeded init without one).  Each pair's mosaic
``pair_{i:04d}.png`` in ``--output_dir`` holds [colour 0 | colour 1 |
colour 1 warped into frame 0 | |warped - colour 0| on the frame-0 object,
jet], and the masked residual's mean is printed.  Runs on the card unless
``--device cpu``; the warp of colour 1 is one K1 launch at C=3.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import warp as W
from ..utils.display import create_mosaic, save_image


def _batch_of_one(item, key, device):
    """``item[key]`` as a batch of one on ``device``."""
    return torch.from_numpy(np.asarray(item[key])[None]).to(device)


def warp_residual_mosaic(item, pose, out_path: str, device="cuda") -> float:
    """Warp ``item``'s colour 1 into frame 0 under ``pose`` (``(R [1,3,3],
    t [1,3])``) through the inverse depth of frame 0, save the mosaic of
    [colour 0 | colour 1 | warped | |warped - colour 0| masked to the
    frame-0 object] at ``out_path``, and return the masked residual's
    mean.  Runs on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    color0, color1, depth0, K = (_batch_of_one(item, k, device)
                                 for k in ("color0", "color1", "depth0", "calib"))
    B, _, H, W_ = depth0.shape
    px, py = W.generate_xy_grid(B, H, W_, K)
    u, v, _ = W.batch_warp_inverse_depth(px, py, 1.0 / depth0, pose, K)
    warped = W.warp_features(color1, u, v)
    residual = (warped - color0).abs().mean(dim=1, keepdim=True)
    if "obj_mask0" in item:
        residual = residual * _batch_of_one(item, "obj_mask0", device)
    mosaic = create_mosaic([t[0].cpu().numpy() for t in (color0, color1, warped, residual)],
                           cmap=[None, None, None, "jet"], rows=2)
    save_image(out_path, mosaic)
    return float(residual.mean())


def build_argparser():
    p = argparse.ArgumentParser(description="Object warping study")
    p.add_argument("--data_root", default=None)
    p.add_argument("--object", default="boat")
    p.add_argument("--preset", default="feature")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--gt_pose", action="store_true", help="use GT instead of tracking")
    p.add_argument("--num_pairs", type=int, default=8)
    p.add_argument("--output_dir", default="warping_objects_out")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from ..data.loader import load_data
    from ..device import resolve_device
    from .serve import build_tracker

    device = resolve_device(args.device)
    dataset = load_data("MovingObjects3D", [1], "test", select_traj=args.object,
                        root=args.data_root)
    os.makedirs(args.output_dir, exist_ok=True)
    net = None if args.gt_pose else build_tracker(args.preset, args.checkpoint, device)

    for i in range(min(args.num_pairs, len(dataset))):
        item = dataset[i]
        one = {k: _batch_of_one(item, k, device) for k in (
            "color0", "color1", "depth0", "depth1", "calib", "transform", "obj_mask0",
            "obj_mask1")}
        if net is None:
            pose = (one["transform"][:, :3, :3], one["transform"][:, :3, 3])
        else:
            with torch.inference_mode():
                pose = net(*(one[k] for k in ("color0", "color1", "depth0", "depth1", "calib")),
                           obj_mask0=one["obj_mask0"], obj_mask1=one["obj_mask1"])
        res = warp_residual_mosaic(item, pose, os.path.join(args.output_dir, f"pair_{i:04d}.png"),
                                   device)
        print(f"[warping_objects] pair {i}: masked residual {res:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
