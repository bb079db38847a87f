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
(``mEst_func``/``solver_func``) and inside each level's update
(``tr_update{i}.mEstimator``/``.directSolver``): an alias whose primary key
is present is dropped, else it loads into the shared module.  Per-level
instances (``mEst_func{i}``, ``scaler_func{i}``, ``solver_func{i}``) belong
to ``no_weight_sharing`` (ROADMAP item 3): they are reported as unmapped,
never loaded into the shared module.  Unmapped keys are printed (fatal
under ``--strict``); the rest loads into the preset's tracker (a seeded
init keeps what the file lacks), which is written as the port's weights
file (``training/checkpoints.py::save_variables``).
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Tuple

import torch

_ALIAS = re.compile(r"tr_update(\d)\.(mEstimator|directSolver)\.(.+)$")
_ALIAS_PRIMARY = {"mEstimator": "mEst_func", "directSolver": "solver_func"}
_PER_LEVEL = re.compile(r"(mEst_func|scaler_func|solver_func)\d\.")


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The file's ``state_dict`` with ``module.`` prefixes stripped (a
    pickle: see the module docstring)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}


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
    for name, value in state.items():
        m = _ALIAS.match(name)
        if m:
            idx, kind, rest = m.groups()
            base = _ALIAS_PRIMARY[kind]
            if f"{base}.{rest}" not in state and f"{base}{idx}.{rest}" not in state:
                aliases.append((name, f"{base}.{rest}"))
            continue
        if _PER_LEVEL.match(name):
            unmapped[name] = "a per-level instance (no_weight_sharing, ROADMAP item 3)"
        elif name in target:
            mapped[name] = value
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

    net = LeastSquareTracking(get_preset(args.preset)).reset_parameters(0)
    target = net.state_dict()
    mapped, unmapped = map_state_dict(read_state_dict(args.torch_checkpoint), target)
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
