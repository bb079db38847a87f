"""Import a checkpoint of the original PyTorch implementation.

Counterpart of ``deep_prob_feature_track_tpu/apps/import_checkpoint.py``
(and its ``models/import_torch.py``): the port's module names are that
implementation's ``state_dict`` keys, so importing is a renaming, not a
layout conversion::

    python -m deep_prob_feature_track_torch.apps.import_checkpoint \
        --torch_checkpoint checkpoint_epoch29.pth.tar \
        --preset feature --output feature_epoch29.pt

The file is read with ``torch.load(..., weights_only=False)``, as the JAX
tool reads it: it is a pickle that may hold arbitrary Python objects (an
epoch count, optimizer state), and unpickling it can run code.  Load only
files from a source you trust.

The keys are the file's ``state_dict`` (or the file itself), with
DataParallel's ``module.`` prefixes stripped.  ``num_batches_tracked`` is
dropped where the port's module has none.  The original registers each
learned M-estimator and damping net twice, on the tracker
(``mEst_func``/``solver_func``, with ``no_weight_sharing`` one a level:
``mEst_func{l}``, ``scaler_func{l}``, ``solver_func{l}``) and inside each
level's update (``tr_update{l}.mEstimator``/``.directSolver``): an alias
whose primary key is present is dropped, else it loads into its level's
module, or into the shared one where the tracker shares them.  As in the
JAX package's converter, a bare ``mEst_func`` is level 0's module of a
tracker with ``no_weight_sharing``, and a ``mEst_func0`` the shared module
of one without it.  A file that holds a module of level 1-3 is read as
``no_weight_sharing``: the preset's tracker is built with a module a
level, as ``models/from_flax.py`` reads a flax tree with a ``*_1``.
Unmapped keys are printed (fatal under ``--strict``); the rest loads into
the preset's tracker (a seeded init keeps what the file lacks), which is
written as the port's weights file
(``training/checkpoints.py::save_variables``).
"""

from __future__ import annotations

import argparse
import dataclasses
import re
from typing import Dict, List, Tuple

import torch

_ALIAS = re.compile(r"tr_update(\d)\.(mEstimator|directSolver)\.(.+)$")
_ALIAS_PRIMARY = {"mEstimator": "mEst_func", "directSolver": "solver_func"}
_LEVEL_NET = re.compile(r"(mEst_func|scaler_func|solver_func)(\d?)\.(.+)$")


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The file's ``state_dict`` with ``module.`` prefixes stripped (a
    pickle: see the module docstring)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}


def has_level_modules(state: Dict[str, torch.Tensor]) -> bool:
    """Whether ``state`` holds a module of level 1-3 (``mEst_func1.``, ...):
    the weights of a tracker with ``no_weight_sharing``."""
    return any(m.group(2) not in ("", "0") for m in map(_LEVEL_NET.match, state) if m)


def _level_key(base: str, idx: str, rest: str, per_level: bool) -> str:
    """The target's key of level ``idx``'s module ``base`` (``""`` for the
    shared one): ``{base}{l}.`` in a tracker with a module a level, where a
    bare name is level 0, else ``{base}.``, where level 0 is the shared
    one."""
    if per_level:
        return f"{base}{idx or 0}.{rest}"
    return f"{base}.{rest}" if idx in ("", "0") else f"{base}{idx}.{rest}"


def map_state_dict(state: Dict[str, torch.Tensor],
                   target: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor],
                                                              Dict[str, str]]:
    """Rename ``state``'s keys onto the keys of ``target`` (a port
    tracker's ``state_dict``).

    :return: ``(mapped, unmapped)``: the tensors to load by port key, and
        each key that maps to nothing with the reason
    """
    mapped: Dict[str, torch.Tensor] = {}
    unmapped: Dict[str, str] = {}
    aliases: List[Tuple[str, str]] = []
    per_level = has_level_modules(target)
    for name, value in state.items():
        m = _ALIAS.match(name)
        if m:
            idx, kind, rest = m.groups()
            base = _ALIAS_PRIMARY[kind]
            if f"{base}.{rest}" not in state and f"{base}{idx}.{rest}" not in state:
                aliases.append((name, _level_key(base, idx if per_level else "", rest,
                                                 per_level)))
            continue
        m = _LEVEL_NET.match(name)
        key = _level_key(*m.groups(), per_level) if m else name
        if key in target:
            mapped[key] = value
        elif not name.endswith("num_batches_tracked"):
            unmapped[name] = "no such key in the preset's tracker"
    for name, key in aliases:
        if key not in target:
            unmapped[name] = "no such key in the preset's tracker"
        elif key in mapped and not torch.equal(mapped[key], state[name]):
            unmapped[name] = f"differs from another alias of {key} (per-level values)"
        else:
            mapped[key] = state[name]
    for key, value in mapped.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"shape mismatch at {key}: tracker {tuple(target[key].shape)} "
                             f"vs checkpoint {tuple(value.shape)}")
    return mapped, unmapped


def main(argv=None):
    p = argparse.ArgumentParser(description="Import a checkpoint of the original PyTorch "
                                            "implementation (a trusted pickle)")
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--preset", default="feature")
    p.add_argument("--output", required=True)
    p.add_argument("--strict", action="store_true",
                   help="fail if any checkpoint key could not be mapped")
    args = p.parse_args(argv)

    from ..models.presets import get_preset
    from ..models.tracker import LeastSquareTracking
    from ..training.checkpoints import save_variables

    state = read_state_dict(args.torch_checkpoint)
    cfg = get_preset(args.preset)
    if has_level_modules(state):
        cfg = dataclasses.replace(cfg, no_weight_sharing=True)
    net = LeastSquareTracking(cfg).reset_parameters(0)
    target = net.state_dict()
    mapped, unmapped = map_state_dict(state, target)
    if unmapped:
        msg = f"[import] {len(unmapped)} unmapped keys: " + ", ".join(
            f"{k} ({unmapped[k]})" for k in sorted(unmapped)[:10])
        if args.strict:
            raise SystemExit(msg)
        print(msg)
    net.load_state_dict(mapped, strict=False)
    save_variables(args.output, net.state_dict())
    print(f"[import] {len(mapped)} of {len(target)} tensors from the checkpoint; "
          f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
