"""Weight bridge: the JAX package's flax variables -> the port's ``state_dict``.

Input is ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (e.g. ``jax.tree.map(np.asarray, variables)``); no JAX import is
needed.  Layout conversions:

* Conv2d kernel HWIO -> OIHW; Conv1d kernel ``(1, in, out)`` -> ``(out, in, 1)``;
  Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``
* BatchNorm ``scale/bias`` -> ``weight/bias`` and
  ``mean/var`` (batch_stats) -> ``running_mean/running_var``

Every leaf must map; the result also carries ``num_batches_tracked`` so
``load_state_dict(strict=True)`` passes.  ``feature_icp`` has ``feature``'s
variables; ``DeepIC`` has the encoder's stages, the M-estimator
(``mests_0``) and the damping MLP (``damping_nets_0``); the empty tree of
``RGB``, ``ICP`` and ``RGB+ICP`` maps to an empty ``state_dict``.

The encoder's heads: ``f_heads_{i}`` is ``f_conv{i}``, a conv block
(``conv``, ``prob_fuse``) or a plain conv (``1by1``); ``s_heads_{i}_0`` is
the conv block ``sigma_conv{i}.0`` of a two-part sigma head (a conv block
and the conv ``s_heads_{i}_1`` -> ``sigma_conv{i}.1``), or the whole
``sigma_conv{i}`` of a ``feature`` sigma head, which has no second part.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

# flax conv block (Conv_0 + BatchNorm_0) -> torch Sequential(conv, bn, elu)
_BLOCKS = (
    (r"encoder/net(\d)/ConvBlock_(\d)", r"encoder.net\1.\2"),
    (r"encoder/f_heads_(\d)", r"encoder.f_conv\1"),
    (r"encoder/s_heads_(\d)_0", r"encoder.sigma_conv\1.0"),
    (r"pose_predictor/ConvBlock_(\d)", r"pose_predictor.net.\1"),
    (r"pose_predictor/Conv1dBlock_0", r"pose_predictor.final_layer.0"),
    (r"mests_0/ConvBlock_(\d)", r"mEst_func.net.\1"),
)
_BLOCK_LEAVES = {
    "Conv_0/kernel": "0.weight",
    "BatchNorm_0/scale": "1.weight",
    "BatchNorm_0/bias": "1.bias",
    "BatchNorm_0/mean": "1.running_mean",
    "BatchNorm_0/var": "1.running_var",
}
# a ``feature`` sigma head is one conv block
_FEATURE_SIGMA_BLOCK = (r"encoder/s_heads_(\d)_0", r"encoder.sigma_conv\1")
# plain flax conv or dense -> torch conv or linear
_CONVS = (
    (r"encoder/f_heads_(\d)", r"encoder.f_conv\1"),
    (r"encoder/s_heads_(\d)_1", r"encoder.sigma_conv\1.1"),
    (r"pose_predictor/Conv_0", r"pose_predictor.final_layer.1"),
    (r"damping_nets_0/FcRelu_(\d)/Dense_0", r"solver_func.net.\1.0"),
)
_CONV_LEAVES = {"kernel": "weight", "bias": "bias"}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: Tuple[str, ...], feature_sigma: bool) -> str:
    name = "/".join(path)
    # the first matching pattern wins
    blocks = (_FEATURE_SIGMA_BLOCK, *_BLOCKS) if feature_sigma else _BLOCKS
    for table, leaves in ((blocks, _BLOCK_LEAVES), (_CONVS, _CONV_LEAVES)):
        for pattern, repl in table:
            m = re.fullmatch(pattern + r"/(.+)", name)
            if m and m.group(m.lastindex) in leaves:
                return m.expand(repl) + "." + leaves[m.group(m.lastindex)]
    raise KeyError(f"flax leaf {name!r} has no counterpart in the port")


def _kernel(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:  # HWIO -> OIHW
        return np.transpose(k, (3, 2, 0, 1))
    if k.ndim == 3:  # (k, in, out) -> (out, in, k)
        return np.transpose(k, (2, 1, 0))
    if k.ndim == 2:  # (in, out) -> (out, in)
        return k.T
    return k


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert flax ``{"params", "batch_stats"}`` into a port ``state_dict``.

    The sigma heads are of the ``feature`` type where ``params`` holds
    ``s_heads_0_0`` but no ``s_heads_0_1``; a tree without ``params`` is
    read as two-part heads.
    """
    enc = variables.get("params", {}).get("encoder", {})
    feature_sigma = "s_heads_0_0" in enc and "s_heads_0_1" not in enc
    state: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})):
            key = _torch_key(path, feature_sigma)
            if key in state:
                raise KeyError(f"two flax leaves map to {key!r}")
            arr = _kernel(value) if key.endswith("weight") else value
            state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state
