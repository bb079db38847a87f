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

Evaluates per (trajectory x keyframe) on the card (``--device cpu`` for
the CPU), dumps per-frame pickles, prints and saves the cm/deg summary CSV
under ``--output_dir/<checkpoint name>``.  The checkpoint is a tracker
``state_dict`` or a training state written by ``apps/train.py``; without
one the weights are a seeded init.  A ``--tracker`` baseline's results go
under ``nolearning_<tracker>``.  ``--time`` prints the stage timers (it
synchronises the card at every stage).

Not ported, and raising ``NotImplementedError``: ``--save_img`` and
``--obj_only`` (ROADMAP item 3), the MovingObjects3D, ScanNet and
VaryLighting datasets (items 3 and 6) and ``--mesh`` (item 8).
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
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--output_dir", default="test_results")
    p.add_argument("--time", action="store_true")
    p.add_argument("--save_img", type=int, default=0, metavar="N")
    p.add_argument("--device", default="cuda")
    return p


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for an option the port lacks, naming
    the ROADMAP item that ports it."""
    missing = [
        (args.save_img > 0, "--save_img", "3"),
        (args.obj_only, "--obj_only", "3"),
        (args.dataset != "TUM_RGBD", f"--dataset {args.dataset}", "3 and 6"),
        (args.mesh, "--mesh", "8"),
    ]
    for hit, what, item in missing:
        if hit:
            raise NotImplementedError(f"{what} is not ported (ROADMAP item {item})")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    refuse_unported(args)
    import numpy as np

    from ..device import resolve_device, set_float32_policy
    from ..evaluation import create_eval_loaders, evaluate_two_view, summarize_results
    from ..utils.timers import Timers
    from .serve import build_tracker

    device = resolve_device(args.device)
    keyframes = [int(k) for k in args.keyframes.split(",")]
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

        def net(c0, c1, d0, d1, K):
            return baseline.batch_track(c0, d0, c1, d1, K)
    else:
        net = build_tracker(args.preset, args.checkpoint, device, overrides=args.set)
        if args.checkpoint:
            ckpt_name = os.path.splitext(os.path.basename(args.checkpoint))[0]
        else:
            print("[evaluate] no checkpoint: random init (non-learned presets unaffected)")
            ckpt_name = f"nolearning_{args.preset}"

    results = {}
    for key, loader in loaders.items():
        info = evaluate_two_view(loader, net, device, timers=timers)
        results[key] = info
        print(
            f"{key}: EPE3D={info['epes'].mean() * 100:.3f}cm  "
            f"axis={np.degrees(info['angular_error'].mean()):.4f}deg  "
            f"trans={info['translation_error'].mean() * 100:.3f}cm  "
            f"({info['epes'].shape[0]} frames)"
        )

    out_dir = os.path.join(args.output_dir, ckpt_name)
    csv_path = os.path.join(out_dir, "summary.csv")
    summarize_results(results, keyframes, output_csv=csv_path, dump_dir=out_dir)
    with open(csv_path) as f:
        print(f.read(), end="")
    if timers:
        timers.print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
