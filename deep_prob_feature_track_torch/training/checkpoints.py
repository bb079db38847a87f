"""Checkpoints: the tracker's weights alone, or the whole training state.

Counterpart of ``save_variables``, ``restore_variables``,
``save_train_state`` and ``restore_train_state`` in
``deep_prob_feature_track_tpu/training/checkpoints.py``.  A weights file is
the tracker's ``state_dict`` (parameters and BatchNorm statistics); a
training state is ``{"net": state_dict, "optimizer": the optimizer's
state_dict, "step": int, "skipped": int}`` (``skipped``: the steps the
non-finite guard skipped, which the learning-rate schedule does not
count).  Both are written with ``torch.save`` and read
with ``weights_only=True``.  The port reads no flax msgpack or orbax file
of the JAX package; ``apps/import_checkpoint`` imports the original
PyTorch implementation's checkpoint (``.pth.tar``) into a weights file.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

_TRAIN_STATE_KEYS = {"net", "optimizer", "step"}


def _save(path: str, obj) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, path)
    return path


def save_variables(path: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write a tracker's ``state_dict``."""
    return _save(path, state_dict)


def restore_variables(path: str) -> Dict[str, Any]:
    """Read a file written by :func:`save_variables` or
    :func:`save_train_state`, onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def tracker_weights(raw: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The tracker's ``state_dict`` in what :func:`restore_variables`
    returned: the file's own content, or a training state's ``net``."""
    return raw["net"] if _TRAIN_STATE_KEYS <= set(raw) else raw


def save_train_state(path: str, state) -> str:
    """Write a ``training.train.TrainState``: weights, optimizer state, step
    and skipped steps."""
    return _save(path, {"net": state.net.state_dict(),
                        "optimizer": state.optimizer.state_dict(), "step": int(state.step),
                        "skipped": int(state.skipped)})


def restore_train_state(path: str, state):
    """Load a file written by :func:`save_train_state` into ``state`` (its
    tracker, optimizer, step and skipped steps, 0 in a file without them),
    in place; returns ``state``.

    The optimizer keeps the hyperparameters it was built with (weight
    decay, Adam's betas and eps, SGD's momentum) and takes only the saved
    per-parameter state (moments, step counts), as the JAX package's
    resume rebuilds its optax chain from the current ``TrainConfig``:
    ``Optimizer.load_state_dict`` alone would put back the saved run's."""
    raw = restore_variables(path)
    state.net.load_state_dict(raw["net"], strict=True)
    current = [{k: v for k, v in group.items() if k != "params"}
               for group in state.optimizer.param_groups]
    state.optimizer.load_state_dict(raw["optimizer"])
    for group, hyper in zip(state.optimizer.param_groups, current):
        group.update(hyper)
    state.step = int(raw["step"])
    state.skipped = int(raw.get("skipped", 0))
    return state
