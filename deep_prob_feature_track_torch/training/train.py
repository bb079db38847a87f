"""Training of the ``feature``, ``feature_icp`` and ``DeepIC`` presets: the
EPE3D or RPE loss, clip -> L2 -> Adam (or SGD with momentum), the epoch loop.

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

Not ported, and raising ``NotImplementedError``: the URPE / UEPE3D losses
(ROADMAP item 4), gradient accumulation (``accum_steps > 1``) and the
non-finite guard (item 5), and the device mesh (item 8).  Checkpoints are
in ``training/checkpoints.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import losses
from ..data.pipeline import to_device
from ..device import resolve_device, set_float32_policy
from ..models.tracker import LeastSquareTracking


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    loss: str = "EPE3D"  # EPE3D | RPE (URPE and UEPE3D are not ported)
    lr: float = 5e-4
    lr_decay_ratio: float = 0.5
    lr_decay_epochs: Tuple[int, ...] = (5, 10, 20)
    weight_decay: float = 4e-4
    grad_clip: float = 5.0
    epochs: int = 30
    batch_size: int = 64
    opt: str = "adam"  # adam | sgd
    accum_steps: int = 1  # only 1 is ported


@dataclasses.dataclass
class TrainState:
    """The tracker in training mode, its optimizer and the step count."""

    net: LeastSquareTracking
    optimizer: torch.optim.Optimizer
    step: int = 0


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
    (``apply_gradients``)."""
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
    the batch norms of the angle and translation errors.
    """
    if train_cfg.loss not in ("EPE3D", "RPE"):
        raise NotImplementedError(
            f"loss {train_cfg.loss!r} is not ported (EPE3D and RPE are; ROADMAP item 4)")
    if not net.training:
        raise ValueError("compute_loss needs the tracker in training mode (net.train())")
    masks = {k: batch[k] for k in ("obj_mask0", "obj_mask1") if k in batch}
    pyr_R, pyr_t = net(batch["color0"], batch["color1"], batch["depth0"], batch["depth1"],
                       batch["calib"], **masks)
    T = batch["transform"]
    if train_cfg.loss == "RPE":
        ang, trs = losses.compute_rpe_loss(pyr_R, pyr_t, T[:, :3, :3], T[:, :3, 3])
        per_sample = (ang + trs).expand(pyr_R.shape[0])
    else:
        depth0 = batch["depth0"]
        invalid = (depth0 == depth0.amin()) | (depth0 == depth0.amax())
        if "obj_mask0" in batch:
            invalid = ~batch["obj_mask0"].bool() | invalid  # the loss on the object alone
        per_sample = 1e2 * losses.compute_rt_epe_loss(
            pyr_R, pyr_t, T[:, :3, :3], T[:, :3, 3], depth0, batch["calib"], invalid=invalid)
    mask = batch.get("pad_mask")
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


def make_train_step(train_cfg: TrainConfig, steps_per_epoch: int, mesh=None,
                    guard_nonfinite: bool = False):
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    forward and backward, clip, optimizer update.  ``state`` is updated in
    place; ``grad_norm`` is the global norm before clipping."""
    if train_cfg.accum_steps != 1:
        raise NotImplementedError(
            "gradient accumulation (accum_steps > 1) is not ported (ROADMAP item 5)")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported (ROADMAP item 8)")
    if guard_nonfinite:
        raise NotImplementedError("the non-finite step guard is not ported (ROADMAP item 5)")
    schedule = make_lr_schedule(train_cfg, steps_per_epoch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.optimizer.zero_grad(set_to_none=True)
        loss = compute_loss(state.net, train_cfg, batch)
        loss.backward()
        grad_norm = apply_gradients(state.optimizer, train_cfg.grad_clip, schedule(state.step))
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def apply_gradients(optimizer: torch.optim.Optimizer, grad_clip: float, lr: float):
    """Clip the gradients of the optimizer's parameters to the global norm
    ``grad_clip``, then take one optimizer step at ``lr``.

    :return: the global gradient norm before clipping
    """
    params = [p for group in optimizer.param_groups for p in group["params"]]
    grad_norm = torch.nn.utils.clip_grad_norm_(params, grad_clip)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return grad_norm


def train_epoch(train_step, state: TrainState, loader, device, log_every: int = 10,
                logger=None, max_steps: int = 0) -> Tuple[TrainState, float]:
    """One epoch over ``loader`` (a ``data.pipeline.BatchLoader``): each
    batch goes to ``device`` and through ``train_step``.  Returns the state
    and the mean loss.

    The losses stay on the device and are reduced once at the end; the host
    waits for the device only at ``log_every`` steps, where one loss is
    read for ``logger``.
    """
    step_losses = []
    t0 = time.time()
    for i, batch in enumerate(loader):
        if max_steps and i >= max_steps:
            break
        batch = to_device({k: v for k, v in batch.items() if not isinstance(v, list)}, device)
        batch["pad_mask"] = torch.as_tensor(batch["pad_mask"], device=device)
        state, metrics = train_step(state, batch)
        step_losses.append(metrics["loss"])
        if logger is not None and i % log_every == 0:
            logger.scalar("train/loss", metrics["loss"].item(), state.step)
            logger.scalar("train/steps_per_sec", (i + 1) / (time.time() - t0), state.step)
    if not step_losses:
        return state, 0.0
    return state, torch.stack(step_losses).mean().item()


def synthetic_batch(B: int, H: int, W: int, seed: int = 0, device="cpu"):
    """A seeded batch of smooth textured scenes.

    Each sample's colors are products of sinusoids (periods of 16 to 63
    pixels); frame 1 shows frame 0's texture shifted by a fraction of a
    pixel.  Depth is a tilted plane with a ripple, 1 to 2.2 m, 1% further in
    frame 1.  The intrinsics are TUM's scaled to HxW, the true motion a few
    centimetres with no rotation.  Smooth scenes keep the 12 chained
    Gauss-Newton solves well conditioned, so two roundings of one step give
    nearly the same gradient; uniform noise images make it chaotic.
    """
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
