"""Evaluation CLI: two-view tracking over TUM-format RGB-D sequences.

Counterpart of ``deep_prob_feature_track_tpu/apps/evaluate.py``::

    python -m deep_prob_feature_track_torch.apps.evaluate \
        --dataset TUM_RGBD --data_root /path/to/tum \
        --preset feature --checkpoint ckpt.pt --keyframes 1,2,4,8

    # one TUM-format sequence directory of one's own
    python -m deep_prob_feature_track_torch.apps.evaluate --data_root "" \
        --trajectory /path/to/sequence --keyframes 1,2

    # a non-learned baseline (apps/baselines.py): ICP, Point2Point,
    # Iter_Point2Plane, RGBD, ColorICP or Iter_ColorICP
    python -m deep_prob_feature_track_torch.apps.evaluate --tracker RGBD ...

    # object motion on MovingObjects3D: the EPE3D over the object's pixels;
    # with --obj_only the tracker gets the object masks too
    python -m deep_prob_feature_track_torch.apps.evaluate \
        --dataset MovingObjects3D --data_root /path/to/mo3d --obj_only \
        --keyframes 1,2,4 --save_img 1

Evaluates per (trajectory x keyframe) on the card (``--device cpu`` for
the CPU), dumps per-frame pickles, prints and saves the cm/deg summary CSV
under ``--output_dir/<checkpoint name>``.  The checkpoint is a tracker
``state_dict`` or a training state written by ``apps/train.py``; without
one the weights are a seeded init.  A ``--tracker`` baseline's results go
under ``nolearning_<tracker>``; it takes and ignores the object masks.
``--time`` prints the stage timers (it synchronises the card at every
stage).  ``--save_img N`` draws the learned tracker's per-level features,
sigma, weighted residual and the finest level's matches for the first N
batches of the first loader, as PNG files under ``<output dir>/vis``
(``dump_diagnostics``).

    # a dataset without ground truth: the poses alone, NaN metrics
    python -m deep_prob_feature_track_torch.apps.evaluate \
        --dataset VaryLighting --data_root /path/to/vl --trajectory <scene>

    # a ScanNet export (``<root>/val/<scan>/frame-XXXXXX.color.jpg``, ...);
    # its colour frames must be 640x480, the depth camera's size
    python -m deep_prob_feature_track_torch.apps.evaluate \
        --dataset ScanNet --data_root /path/to/scannet --keyframes 1

    # the batches split over the ranks of a mesh (parallel/mesh.py): the
    # ranks torchrun starts, or this process alone
    torchrun --nproc_per_node 4 -m deep_prob_feature_track_torch.apps.evaluate \
        --mesh --batch_size 8 ...

With ``--mesh`` the batch size must divide by the world size; each rank
tracks its rows of every batch with the batch reductions over the whole
batch, the poses are gathered, and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import os


def build_argparser():
    p = argparse.ArgumentParser(description="Evaluate two-view tracking")
    p.add_argument("--dataset", default="TUM_RGBD",
                   choices=("TUM_RGBD", "MovingObjects3D", "ScanNet", "VaryLighting"))
    p.add_argument("--data_root", default=None)
    p.add_argument("--preset", default="feature")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any TrackerConfig field on top of --preset")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--keyframes", default="1,2,4,8")
    p.add_argument("--trajectory", default="")
    p.add_argument("--eval_set", default="test", choices=("test", "validation"))
    p.add_argument("--image_resize", type=float, default=0.25)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--tracker", default="learning_based",
                   choices=("learning_based", "ICP", "Point2Point",
                            "Iter_Point2Plane", "RGBD", "ColorICP",
                            "Iter_ColorICP"))
    p.add_argument("--obj_only", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="split each batch over the ranks of a torch.distributed group "
                        "(the batch size must divide by the world size)")
    p.add_argument("--output_dir", default="test_results")
    p.add_argument("--time", action="store_true")
    p.add_argument("--save_img", type=int, default=0, metavar="N")
    p.add_argument("--device", default="cuda")
    return p


def dump_diagnostics(net, loader, out_dir, n_batches, device, has_mask=False):
    """Draw the tracker's per-level diagnostics (``track_diagnostics``) of
    the first item of each of the first ``n_batches`` batches into
    ``out_dir/batch{i:03d}/``: ``feat0_l{level}.png`` (the RGB image, the
    channel mean and each channel of the frame-0 features),
    ``sigma0_l{level}.png`` (the channel-mean sigma, jet),
    ``residual_l{level}.png`` (the channel-mean |weighted residual|, jet)
    and ``matches.png`` (the finest level's valid matches on frame 1).
    With ``has_mask`` the object masks go to the tracker."""
    import numpy as np
    import torch

    from ..data.pipeline import to_device
    from ..evaluation import KEYS
    from ..utils import display

    os.makedirs(out_dir, exist_ok=True)
    for bi, batch in enumerate(loader):
        if bi >= n_batches:
            break
        dev = to_device(batch, device)
        masks = {}
        if has_mask and "obj_mask0" in batch:
            masks = {k: dev[k] for k in ("obj_mask0", "obj_mask1")}
        with torch.inference_mode():
            _, diag = net.track_diagnostics(*(dev[k] for k in KEYS), **masks)

        def first(t):
            return t[0].cpu().numpy()

        bdir = os.path.join(out_dir, f"batch{bi:03d}")
        os.makedirs(bdir, exist_ok=True)
        rgb0 = batch["color0"][0]
        for lvl in range(4):
            display.save_image(os.path.join(bdir, f"feat0_l{lvl}.png"),
                               display.visualize_feature_channels(
                                   first(diag["features0"][lvl]), rgb=rgb0))
            display.save_image(os.path.join(bdir, f"sigma0_l{lvl}.png"),
                               display.image_to_display(first(diag["sigma0"][lvl]).mean(axis=0),
                                                        cmap="jet"))
            display.save_image(os.path.join(bdir, f"residual_l{lvl}.png"),
                               display.image_to_display(
                                   np.abs(first(diag["residual"][lvl])).mean(axis=0),
                                   cmap="jet"))
        coords, ok = diag["matches"][0]
        display.save_image(os.path.join(bdir, "matches.png"),
                           display.visualize_matches_on_image(
                               batch["color1"][0], first(coords)[:, first(ok)]))
    print(f"[evaluate] wrote diagnostics mosaics to {out_dir}")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from ..device import resolve_device
    from ..parallel.mesh import destroy, make_mesh

    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        mesh = make_mesh(device)
        if args.batch_size % mesh.world:
            destroy()
            raise SystemExit(f"--mesh: batch_size {args.batch_size} not divisible by "
                             f"{mesh.world} ranks")
    try:
        return evaluate(args, mesh.device if mesh else device, mesh)
    finally:
        if mesh is not None:
            destroy()


def evaluate(args, device, mesh) -> int:
    """The CLI's work after the mesh is made."""
    import numpy as np

    from ..device import set_float32_policy
    from ..evaluation import create_eval_loaders, evaluate_two_view, summarize_results
    from ..utils.timers import Timers
    from .serve import build_tracker

    keyframes = [int(k) for k in args.keyframes.split(",")]
    has_mask = args.dataset == "MovingObjects3D"
    timers = Timers(block=True) if args.time else None
    loaders = create_eval_loaders(
        args.dataset, args.eval_set, keyframes, args.batch_size,
        trajectory=args.trajectory, image_resize=args.image_resize,
        root=args.data_root,
    )
    if args.tracker != "learning_based":
        from .baselines import make_baseline

        set_float32_policy()
        baseline = make_baseline(args.tracker)
        ckpt_name = f"nolearning_{args.tracker}"

        def net(c0, c1, d0, d1, K, obj_mask0=None, obj_mask1=None):
            return baseline.batch_track(c0, d0, c1, d1, K, obj_mask0, obj_mask1)
    else:
        net = build_tracker(args.preset, args.checkpoint, device, overrides=args.set)
        if args.checkpoint:
            ckpt_name = os.path.splitext(os.path.basename(args.checkpoint))[0]
        else:
            print("[evaluate] no checkpoint: random init (non-learned presets unaffected)")
            ckpt_name = f"nolearning_{args.preset}"

    results = {}
    for key, loader in loaders.items():
        info = evaluate_two_view(loader, net, device, has_mask=has_mask,
                                 obj_only=args.obj_only, timers=timers, mesh=mesh)
        results[key] = info
        if "epes" in info:
            print(
                f"{key}: EPE3D={info['epes'].mean() * 100:.3f}cm  "
                f"axis={np.degrees(info['angular_error'].mean()):.4f}deg  "
                f"trans={info['translation_error'].mean() * 100:.3f}cm  "
                f"({info['epes'].shape[0]} frames)"
            )
        else:  # a dataset without ground truth (VaryLighting)
            print(f"{key}: no ground truth; {info['R_est'].shape[0]} poses estimated")

    if mesh is not None and not mesh.is_main:
        return 0
    out_dir = os.path.join(args.output_dir, ckpt_name)
    if args.save_img > 0 and args.tracker == "learning_based":
        dump_diagnostics(net, next(iter(loaders.values())), os.path.join(out_dir, "vis"),
                         args.save_img, device, has_mask=has_mask)
    csv_path = os.path.join(out_dir, "summary.csv")
    summarize_results(results, keyframes, output_csv=csv_path, dump_dir=out_dir)
    with open(csv_path) as f:
        print(f.read(), end="")
    if timers:
        timers.print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
