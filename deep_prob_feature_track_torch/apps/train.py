"""Training CLI: the tracker on TUM-format RGB-D sequences, or on
MovingObjects3D (the object's relative motion, with its masks).

Counterpart of ``deep_prob_feature_track_tpu/apps/train.py``::

    python -m deep_prob_feature_track_torch.apps.train \
        --dataset TUM_RGBD --data_root /path/to/tum \
        --preset feature --epochs 30 --batch_size 64

Per epoch: a checkpoint (``checkpoint_epoch{e}.pt``, a training state) every
``--save_checkpoint_freq`` epochs, validation over (trajectory x keyframe)
loaders unless ``--no_val``, one training epoch with JSONL (and, where
TensorBoard imports, event file) logging under
``--checkpoint_folder/<run name>``; a final checkpoint at the end.
``--checkpoint`` resumes from a training state, at epoch ``step //
steps_per_epoch``.  Runs on the card unless ``--device cpu``.

``random`` and ``numpy`` are seeded before the data is built, as in the JAX
CLI, so the loader's keyframe draws repeat from run to run.  The JAX CLI
also loads one example batch to build flax's variables, which draws
keyframes and colour jitter before training starts; the port's seeded init
needs no input, so its first epoch sees other keyframe gaps than the JAX
CLI's.  On TUM, validation without ``--no_val`` reads the validation part
of the four test sequences, which lie outside the training split: the
loaders are empty, and the first epoch stops with a ``KeyError`` on
``'epes'``, as the JAX CLI does.  On MovingObjects3D the same happens:
validation reads the test objects (boat, motorbike) from the validation
split, which holds none.

``--loss UEPE3D|URPE`` turns on the tracker's ``uncer_prop``, as the JAX
CLI does.  Such a tracker's eval forward returns ``((R, t), JtWJ)``, which
``evaluate_two_view`` cannot take as a pose: validation without
``--no_val`` stops with a ``ValueError`` at its first batch, as the JAX
CLI's does (on TUM its empty loaders stop it with the ``KeyError`` above
first).

``--dataset VaryLighting`` stops at its loader, which takes the test and
keyframe categories only (an ``AssertionError``), as the JAX CLI does.

``--accum_steps N`` splits each batch into N microbatches and takes one
update of their averaged gradient (``training/train.py``); ``--accum_loop``
takes the JAX CLI's choices and is ignored: the port has one loop.

The training memory modes, named after the JAX package's environment
variables (the port reads none): ``--train_loop scan_remat`` recomputes
each Gauss-Newton iteration in the backward (``DPFT_TRAIN_LOOP``),
``--remat_encoder`` each encoder pass (``DPFT_REMAT_ENCODER=1``), and
``--bf16_residuals`` keeps the gathers' derivative maps in bfloat16
(``DPFT_BF16_RESIDUALS=1``); they go to ``LeastSquareTracking``.  With the
first two a step gives the bits it gives without them.

Data parallel (``parallel/mesh.py``), one process per card::

    torchrun --nproc_per_node 4 -m deep_prob_feature_track_torch.apps.train \
        --distributed --batch_size 64 ...

``--distributed`` joins the process group that ``torchrun``'s environment
describes (``--mesh`` does too, and alone makes a group of this process);
``--batch_size`` is the global batch, each rank loads its shard
(``BatchLoader(shard_index=rank, num_shards=world)``), and the step is the
global step of a JAX mesh: BatchNorm statistics, batch-global min/max and
the loss mean over the global batch, gradients summed over the ranks.
Rank 0 alone logs and writes checkpoints.  ``--debug_nan`` makes the step
raise at the first non-finite value, naming the module or autograd node
that produced it (``utils/debug.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="Train the feature-metric tracker")
    p.add_argument("--dataset", default="TUM_RGBD",
                   choices=("TUM_RGBD", "MovingObjects3D", "ScanNet", "VaryLighting"))
    p.add_argument("--data_root", default=None)
    p.add_argument("--preset", default="feature")
    p.add_argument("--keyframes", default="1,2,4,8")
    p.add_argument("--image_resize", type=float, default=0.25)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--loss", default="EPE3D", choices=("EPE3D", "RPE", "UEPE3D", "URPE"))
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any TrackerConfig field on top of --preset "
                        "(e.g. --set feature_channel=4 --set combine_icp=1)")
    p.add_argument("--opt", default="adam", choices=("adam", "sgd"))
    p.add_argument("--lr_decay_ratio", type=float, default=0.5)
    p.add_argument("--lr_decay_epochs", default="5,10,20",
                   help="comma-separated epoch boundaries for MultiStepLR")
    p.add_argument("--weight_decay", type=float, default=4e-4)
    p.add_argument("--grad_clip", type=float, default=5.0)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--accum_loop", default="host", choices=("host", "scan"),
                   help="ignored: the JAX CLI's choice of accumulation loop, an XLA "
                        "compile choice; the port runs one loop for both")
    p.add_argument("--train_loop", default="unroll", choices=("unroll", "scan_remat"),
                   help="scan_remat: recompute each Gauss-Newton iteration in the backward "
                        "(the tracker's remat_gn)")
    p.add_argument("--remat_encoder", action="store_true",
                   help="recompute each encoder pass in the backward")
    p.add_argument("--bf16_residuals", action="store_true",
                   help="keep the gathers' derivative maps in bfloat16")
    p.add_argument("--checkpoint", default="", help="resume checkpoint")
    p.add_argument("--checkpoint_folder", default="logs")
    p.add_argument("--save_checkpoint_freq", type=int, default=1)
    p.add_argument("--no_val", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel over a torch.distributed group")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group of torchrun's environment")
    p.add_argument("--debug_nan", action="store_true",
                   help="raise at the first non-finite value of a step (slow)")
    p.add_argument("--seed", type=int, default=1)
    # the JAX CLI's flag, which it never reads: accepted, with no effect
    p.add_argument("--time", action="store_true", help="stage timing")
    p.add_argument("--max_steps_per_epoch", type=int, default=0,
                   help="truncate epochs (smoke tests)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    # fixed seeds, as the JAX CLI and the reference seed them
    random.seed(args.seed)
    np.random.seed(args.seed)

    from ..device import resolve_device
    from ..parallel.mesh import destroy, make_mesh

    device = resolve_device(args.device)
    mesh = make_mesh(device) if (args.mesh or args.distributed) else None
    try:
        return train(args, mesh.device if mesh else device, mesh)
    finally:
        if mesh is not None:
            destroy()


def train_config(args):
    """The ``TrainConfig`` of the parsed arguments (``--accum_loop`` has no
    part in it)."""
    from ..training.train import TrainConfig

    return TrainConfig(
        loss=args.loss, lr=args.lr, epochs=args.epochs,
        batch_size=args.batch_size, opt=args.opt,
        lr_decay_ratio=args.lr_decay_ratio,
        lr_decay_epochs=tuple(int(e) for e in args.lr_decay_epochs.split(",") if e),
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        accum_steps=args.accum_steps,
    )


def train(args, device, mesh) -> int:
    """The CLI's work after the mesh is made."""
    from ..data.loader import load_data
    from ..data.pipeline import BatchLoader
    from ..evaluation import create_eval_loaders, evaluate_two_view
    from ..models.presets import apply_overrides, get_preset
    from ..models.tracker import LeastSquareTracking
    from ..parallel.mesh import replicate
    from ..training import checkpoints
    from ..training.train import create_train_state, make_train_step, train_epoch
    from ..utils.logger import MetricsLogger, config_fingerprint, git_revision

    main_process = mesh is None or mesh.is_main
    world, rank = (mesh.world, mesh.rank) if mesh else (1, 0)
    cfg = apply_overrides(get_preset(args.preset), args.set)
    if args.loss in ("UEPE3D", "URPE"):
        cfg = dataclasses.replace(cfg, uncer_prop=True)
    keyframes = [int(k) for k in args.keyframes.split(",")]

    run_name = f"{args.dataset}_{config_fingerprint(cfg)}_lr_{args.lr}_batch_{args.batch_size}"
    logdir = os.path.join(args.checkpoint_folder, run_name)
    logger = MetricsLogger(logdir, is_main_process=main_process)
    print(f"[train] logdir={logdir} git={git_revision()}")

    train_set = load_data(
        args.dataset, keyframes, "train", image_resize=args.image_resize,
        root=args.data_root, augment_seed=args.seed,
    )
    # --batch_size is the global batch; each rank loads its own shard
    if args.batch_size % world:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible by {world} ranks")
    loader = BatchLoader(train_set, args.batch_size // world, shuffle=True, seed=args.seed,
                         drop_last=True, shard_index=rank, num_shards=world)
    steps_per_epoch = max(len(loader), 1)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    tcfg = train_config(args)
    net = LeastSquareTracking(cfg, remat_gn=args.train_loop == "scan_remat",
                              remat_encoder=args.remat_encoder,
                              bf16_residuals=args.bf16_residuals)
    state = create_train_state(net, tcfg, seed=args.seed, device=device)
    if args.checkpoint:
        state = checkpoints.restore_train_state(args.checkpoint, state)
        print(f"[train] resumed from {args.checkpoint} at step {state.step}")
    if mesh is not None:
        replicate(mesh, state.net)
    step_fn = make_train_step(tcfg, steps_per_epoch, mesh=mesh)
    if args.debug_nan:
        from ..utils.debug import checked

        step_fn = checked(step_fn, state.net)

    val_loaders = {}
    if not args.no_val:
        try:
            val_loaders = create_eval_loaders(
                args.dataset, "validation", keyframes, args.batch_size,
                image_resize=args.image_resize, root=args.data_root,
            )
        except (OSError, ValueError) as e:  # validation data is optional
            print(f"[train] validation loaders unavailable: {e}")

    start_epoch = state.step // steps_per_epoch
    for epoch in range(start_epoch, args.epochs):
        if epoch % args.save_checkpoint_freq == 0 and main_process:
            path = os.path.join(logdir, f"checkpoint_epoch{epoch}.pt")
            checkpoints.save_train_state(path, state)
            print(f"[train] saved {path}")

        if val_loaders:
            state.net.eval()
            for k, vloader in val_loaders.items():
                info = evaluate_two_view(vloader, state.net, device)
                logger.scalar(f"val/{k}/epe3d", float(info["epes"].mean()), epoch)
            state.net.train()

        t0 = time.time()
        state, mean_loss = train_epoch(step_fn, state, loader, device, logger=logger,
                                       max_steps=args.max_steps_per_epoch, mesh=mesh)
        print(f"[train] epoch {epoch}: loss={mean_loss:.4f} "
              f"({time.time() - t0:.1f}s, step={state.step})")
        logger.scalar("train/epoch_loss", mean_loss, epoch)

    if main_process:
        path = os.path.join(logdir, f"checkpoint_epoch{args.epochs}.pt")
        checkpoints.save_train_state(path, state)
        print(f"[train] saved final {path}")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
