"""Training of the tracker: the EPE3D, RPE, URPE or UEPE3D loss, clip -> L2
-> Adam (or SGD with momentum), the epoch loop.

Counterpart of ``TrainConfig``, ``make_lr_schedule``, ``make_optimizer``,
``compute_loss``, ``create_train_state``, ``make_train_step`` and
``train_epoch`` in ``deep_prob_feature_track_tpu/training/train.py``.  The
optimizer chain is the JAX package's optax chain: the gradients are clipped
to a global norm of 5.0, then ``torch.optim.Adam`` (or ``SGD`` with momentum
0.9, optax's ``trace(0.9)``) folds the L2 weight decay into them
(``clip_by_global_norm`` -> ``add_decayed_weights`` -> ``scale_by_adam`` or
``trace`` -> learning rate).  A step of ``feature`` under autograd runs
kernels K2 and K6 in the forward and K3 in the backward, 12 times each;
``feature_icp`` runs K2 24 times, once more per iteration for the ICP warp of
the input depth's vertices and normals, whose operand needs no cotangent (no
K3).  ``DeepIC`` runs K1 once (level 3's first occlusion depth, where nothing
needs a gradient), K2 50 times (12 a level: its first residual, the folded
damping samples of 3 iterations and 2 new residuals each warp the features
and the occlusion depth; and the M-estimator's 3 upsamples) and K3 27 times
(the feature warps and the upsamples); no K6.

A batch with object masks (``obj_mask0/1``, MovingObjects3D) trains the
object's relative motion: the masks go to the tracker, and the EPE3D loss
counts only the frame-0 object's pixels.

The uncertainty losses need a tracker with ``uncer_prop``, whose training
forward returns each level's 6x6 information matrix JtWJ: URPE weighs the
twist error with it, UEPE3D inverts ``lev_mar_damp`` of it into the pose
covariance it pushes through the flow Jacobian (in the U_IC track the
gradient then reaches K6's JtJ output).

Gradient accumulation (``accum_steps > 1``) splits the batch into equal
microbatches in order; each runs the training forward with its own
BatchNorm batch statistics (the running statistics chain from one to the
next), the gradients and losses are summed and divided by ``accum_steps``,
and one clip and one optimizer step follow.  The JAX package's two forms
of that loop (``accum_loop`` ``host`` and ``scan``) are an XLA compile
choice with the same semantics: the port has the one Python loop, and no
such field.

The non-finite guard (``guard_nonfinite=True``) reads ``isfinite(loss) &
isfinite(grad_norm)`` on the host once a step; where it is false, the
parameters, the optimizer state (Adam's moments and per-parameter step)
and the BatchNorm running statistics keep their pre-step values bit for
bit, ``state.step`` still advances and ``metrics["skipped"]`` is true.
The learning-rate schedule counts the updates taken (``state.step -
state.skipped``), as optax's schedule counts in the optimizer state that
the guard keeps; a checkpoint keeps ``skipped`` beside ``step``.

With a mesh (``parallel/mesh.py``, one process per card) the step is the
global program, sharded as in a JAX mesh step: each rank holds its rows of
the global batch, BatchNorm statistics and the batch-global min/max run
over the global batch, each rank's loss is its share of the global mean,
and the gradients are summed over the ranks before the clip, so every rank
applies the same update.  With accumulation, microbatch i is the global
rows ``[i*B/accum, (i+1)*B/accum)``, split over the ranks (the JAX scan
mode, the one mode JAX allows with a mesh): the ranks first gather the
global batch.  Checkpoints are in ``training/checkpoints.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import losses
from ..data.pipeline import to_device
from ..device import resolve_device, set_float32_policy
from ..models.tracker import LeastSquareTracking
from ..ops.solver6 import lev_mar_damp
from ..parallel import mesh as M
from ..parallel.mesh import extrema_mask


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    loss: str = "EPE3D"  # EPE3D | RPE | URPE | UEPE3D (the last two need uncer_prop)
    lr: float = 5e-4
    lr_decay_ratio: float = 0.5
    lr_decay_epochs: Tuple[int, ...] = (5, 10, 20)
    weight_decay: float = 4e-4
    grad_clip: float = 5.0
    epochs: int = 30
    batch_size: int = 64
    opt: str = "adam"  # adam | sgd
    accum_steps: int = 1  # microbatches per step


@dataclasses.dataclass
class TrainState:
    """The tracker in training mode, its optimizer and the step count."""

    net: LeastSquareTracking
    optimizer: torch.optim.Optimizer
    step: int = 0
    skipped: int = 0  # steps the non-finite guard skipped


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step MultiStep schedule: ``lr * ratio^k`` once ``k`` decay
    epochs have begun (optax's ``piecewise_constant_schedule``)."""
    boundaries = sorted({int(e * steps_per_epoch) for e in cfg.lr_decay_epochs})

    def schedule(step: int) -> float:
        lr = cfg.lr
        for b in boundaries:
            if step >= b:
                lr *= cfg.lr_decay_ratio
        return lr

    return schedule


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam, or SGD with momentum 0.9, with the L2 weight decay folded into
    the gradient; the step clips the gradients before it
    (:func:`clip_gradients`, then :func:`apply_update`)."""
    if cfg.opt == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    if cfg.opt == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.opt!r}: use 'adam' or 'sgd'")


def compute_loss(net: LeastSquareTracking, train_cfg: TrainConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Training forward + loss of one batch; updates the BatchNorm running
    statistics.

    Batch keys: color0/1 [B,3,H,W], depth0/1 [B,1,H,W], calib [B,4],
    transform [B,4,4] and optionally pad_mask [B] and the bool object masks
    obj_mask0/1 [B,1,H,W], which go to the tracker.  EPE3D: pixels at the
    batch-global depth min or max, and pixels outside the frame-0 object,
    are left out of the loss, and the loss is
    ``1e2`` times the EPE3D summed over the pose pyramid, averaged over the
    samples that ``pad_mask`` keeps.  RPE: over the pose pyramid, the sum of
    the batch norms of the angle and translation errors.  URPE: the batch
    total of :func:`losses.compute_rpe_uncertainty_loss` under the levels'
    information matrices, spread evenly over the samples.  UEPE3D: the
    negative log-likelihood of
    :func:`losses.compute_rt_epe_uncertainty_loss` with each level's
    covariance ``lev_mar_damp(JtWJ)^-1``, over EPE3D's valid pixels.  URPE
    and UEPE3D need a tracker with ``uncer_prop``.
    """
    if train_cfg.loss not in ("EPE3D", "RPE", "URPE", "UEPE3D"):
        raise ValueError(f"unknown loss {train_cfg.loss!r}")
    if not net.training:
        raise ValueError("compute_loss needs the tracker in training mode (net.train())")
    if train_cfg.loss in ("URPE", "UEPE3D") and not net.cfg.uncer_prop:
        raise ValueError(f"the {train_cfg.loss} loss needs a tracker with uncer_prop")
    masks = {k: batch[k] for k in ("obj_mask0", "obj_mask1") if k in batch}
    out = net(batch["color0"], batch["color1"], batch["depth0"], batch["depth1"],
              batch["calib"], **masks)
    pyr_R, pyr_t = out[:2]
    T = batch["transform"]
    R_gt, t_gt = T[:, :3, :3], T[:, :3, 3]
    depth0 = batch["depth0"]
    invalid = extrema_mask(depth0)
    if "obj_mask0" in batch:
        invalid = ~batch["obj_mask0"].bool() | invalid  # the loss on the object alone
    if train_cfg.loss == "RPE":
        ang, trs = losses.compute_rpe_loss(pyr_R, pyr_t, R_gt, t_gt)
        per_sample = (ang + trs).expand(pyr_R.shape[0])
    elif train_cfg.loss == "URPE":
        total = losses.compute_rpe_uncertainty_loss(pyr_R, pyr_t, R_gt, t_gt, out[2])
        per_sample = (total / pyr_R.shape[0]).expand(pyr_R.shape[0])
    elif train_cfg.loss == "UEPE3D":
        info = out[2]
        sigma = torch.linalg.inv(lev_mar_damp(info.reshape(-1, 6, 6))).reshape(info.shape)
        per_sample, _ = losses.compute_rt_epe_uncertainty_loss(
            pyr_R, pyr_t, R_gt, t_gt, depth0, batch["calib"], sigma, invalid=invalid)
    else:
        per_sample = 1e2 * losses.compute_rt_epe_loss(
            pyr_R, pyr_t, R_gt, t_gt, depth0, batch["calib"], invalid=invalid)
    mask = batch.get("pad_mask")
    mesh = M.current()
    if mesh is not None and mesh.world > 1:
        # this rank's share of the global batch's mean
        if mask is None:
            mask = torch.ones_like(per_sample)
        mask = mask.to(per_sample.dtype)
        count = mask.sum().detach()
        dist.all_reduce(count, group=mesh.group)
        return (per_sample * mask).sum() / count.clamp(min=1)
    if mask is None:
        return per_sample.mean()
    mask = mask.to(per_sample.dtype)
    return (per_sample * mask).sum() / mask.sum().clamp(min=1)


def create_train_state(net: LeastSquareTracking, train_cfg: TrainConfig, seed: int = 1,
                       device="cuda") -> TrainState:
    """Seed ``net``'s weights, move it to ``device`` (the card unless the
    caller asks for the CPU) in training mode, and build its optimizer."""
    dev = resolve_device(device)
    set_float32_policy()
    net.reset_parameters(seed)
    net.to(dev).train()
    return TrainState(net=net, optimizer=make_optimizer(train_cfg, net.parameters()))


def make_train_step(train_cfg: TrainConfig, steps_per_epoch: int, mesh: Optional[M.Mesh] = None,
                    guard_nonfinite: bool = False):
    """``step(state, batch) -> (state, {"loss", "grad_norm"[, "skipped"]})``:
    the forward and backward of ``accum_steps`` microbatches, one clip, one
    optimizer update.  ``state`` is updated in place; ``grad_norm`` is the
    global norm of the averaged gradient before clipping, ``loss`` the mean
    over the microbatches (with a mesh, of the global batch).

    :param mesh: a ``parallel.mesh.Mesh``: ``batch`` is this rank's rows of
        the global batch, and the step is the global step (see the module)
    :param guard_nonfinite: skip the update where the loss or the gradient
        norm is not finite (``metrics["skipped"]``)
    """
    accum = int(train_cfg.accum_steps)
    if accum < 1:
        raise ValueError(f"accum_steps must be at least 1, not {accum}")
    schedule = make_lr_schedule(train_cfg, steps_per_epoch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        kept = [b.clone() for b in state.net.buffers()] if guard_nonfinite else None
        state.optimizer.zero_grad(set_to_none=True)
        with M.active(mesh):
            loss = None
            for mb in microbatches(batch, accum, mesh):
                part = compute_loss(state.net, train_cfg, mb)
                part.backward()
                loss = part.detach() if loss is None else loss + part.detach()
        if accum > 1:
            loss = loss / accum
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum)
        if mesh is not None and mesh.world > 1:
            dist.all_reduce(loss, group=mesh.group)
            sum_gradients(mesh, params)
        grad_norm = clip_gradients(params, train_cfg.grad_clip)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        ok = True
        if guard_nonfinite:
            ok_t = torch.isfinite(loss) & torch.isfinite(grad_norm)
            metrics["skipped"] = ~ok_t
            ok = bool(ok_t)  # the one host read of the step
        if ok:
            apply_update(state.optimizer, schedule(state.step - state.skipped))
        else:
            # clip_grad_norm_ wrote NaN into the gradients: no update, and
            # the running statistics back to their pre-step bits
            with torch.no_grad():
                for buf, old in zip(state.net.buffers(), kept):
                    buf.copy_(old)
            state.skipped += 1
        state.step += 1
        return state, metrics

    return step


def microbatches(batch: Dict[str, torch.Tensor], accum: int, mesh: Optional[M.Mesh] = None):
    """The ``accum`` microbatches of ``batch``, equal slices in order.  With
    a mesh of several ranks, ``batch`` is this rank's rows of the global
    batch; microbatch i is the global rows ``[i*B/accum, (i+1)*B/accum)``
    and this rank gets its equal part of them."""
    if accum == 1:
        yield batch
        return
    if mesh is not None and mesh.world > 1:
        batch = {k: M.all_gather_rows(mesh, v) for k, v in batch.items()}
    B = batch["color0"].shape[0]
    if B % accum:
        raise ValueError(f"batch dim {B} not divisible by accum_steps={accum}")
    size = B // accum
    for i in range(accum):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        yield mb if mesh is None or mesh.world == 1 else M.shard_batch(mesh, mb)


def sum_gradients(mesh: M.Mesh, params) -> None:
    """Sum the parameters' gradients over the ranks, in place, in one
    all-reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def clip_gradients(params, grad_clip: float) -> torch.Tensor:
    """Clip the parameters' gradients to the global norm ``grad_clip``, in
    place (optax's ``clip_by_global_norm``); returns the norm before
    clipping.  A non-finite norm writes NaN into the gradients."""
    return torch.nn.utils.clip_grad_norm_(params, grad_clip)


def apply_update(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """One optimizer step at the learning rate ``lr``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def train_epoch(train_step, state: TrainState, loader, device, log_every: int = 10,
                logger=None, max_steps: int = 0, mesh=None) -> Tuple[TrainState, float]:
    """One epoch over ``loader`` (a ``data.pipeline.BatchLoader``): each
    batch goes to ``device`` and through ``train_step``.  Returns the state
    and the mean loss.  With a mesh, ``train_step`` is the mesh's step and
    the loader either holds this rank's shard (``BatchLoader(shard_index=
    rank, num_shards=world)``) or yields global batches, of which each
    rank takes its rows.

    The losses stay on the device and are reduced once at the end; the host
    waits for the device only at ``log_every`` steps, where one loss is
    read for ``logger``.
    """
    step_losses = []
    t0 = time.time()
    for i, batch in enumerate(loader):
        if max_steps and i >= max_steps:
            break
        batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        if mesh is not None and getattr(loader, "num_shards", 1) != mesh.world:
            batch = M.shard_batch(mesh, batch)
        batch = to_device(batch, device)
        batch["pad_mask"] = torch.as_tensor(batch["pad_mask"], device=device)
        state, metrics = train_step(state, batch)
        step_losses.append(metrics["loss"])
        if logger is not None and i % log_every == 0:
            logger.scalar("train/loss", metrics["loss"].item(), state.step)
            logger.scalar("train/steps_per_sec", (i + 1) / (time.time() - t0), state.step)
    if not step_losses:
        return state, 0.0
    return state, torch.stack(step_losses).mean().item()


def synthetic_batch(B: int, H: int, W: int, seed: int = 0, device="cuda"):
    """A seeded batch of smooth textured scenes.

    Each sample's colors are products of sinusoids (periods of 16 to 63
    pixels); frame 1 shows frame 0's texture shifted by a fraction of a
    pixel.  Depth is a tilted plane with a ripple, 1 to 2.2 m, 1% further in
    frame 1.  The intrinsics are TUM's scaled to HxW, the true motion a few
    centimetres with no rotation.  Smooth scenes keep the 12 chained
    Gauss-Newton solves well conditioned, so two roundings of one step give
    nearly the same gradient; uniform noise images make it chaotic.  The
    batch lies on the card unless ``device="cpu"``.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    y = np.arange(H)[None, None, :, None]
    x = np.arange(W)[None, None, None, :]
    freq = rng.uniform(0.1, 0.4, (2, B, 3, 1, 1))
    phase = rng.uniform(0.0, 6.0, (B, 3, 1, 1))
    shift = rng.uniform(0.3, 1.0, (B, 1, 1, 1))

    def texture(dx):
        return 0.5 + 0.4 * np.sin(freq[0] * (x + dx) + phase) * np.cos(freq[1] * y + phase)

    tilt = rng.uniform(0.3, 0.7, (2, B, 1, 1, 1))
    depth = 1.0 + tilt[0] * x / W + tilt[1] * y / H + 0.1 * np.sin(x / 5.0)
    T = np.tile(np.eye(4), (B, 1, 1))
    T[:, :3, 3] = rng.randn(B, 3) * 0.01
    arrays = {
        "color0": texture(0.0),
        "color1": texture(shift),
        "depth0": depth,
        "depth1": depth * 1.01,
        "calib": np.tile([[525.0 * W / 640, 525.0 * H / 480, (W - 0.5) / 2, (H - 0.5) / 2]],
                         (B, 1)),
        "transform": T,
    }
    batch = {k: torch.from_numpy(a.astype(np.float32)).to(device) for k, a in arrays.items()}
    batch["pad_mask"] = torch.ones(B, dtype=torch.bool, device=device)
    return batch
