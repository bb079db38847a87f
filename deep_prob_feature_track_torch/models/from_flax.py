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
variables (with a learned ``ScaleNet``, ``scalers_0`` too); ``DeepIC`` has
the encoder's stages, the M-estimator (``mests_0``) and the damping MLP
(``damping_nets_0``); the empty tree of ``RGB``, ``ICP`` and ``RGB+ICP``
maps to an empty ``state_dict``.  With ``no_weight_sharing`` the tree holds
``mests_{l}``, ``scalers_{l}`` and ``damping_nets_{l}`` for the levels l =
0-3, which map to ``mEst_func{l}``, ``scaler_func{l}`` and
``solver_func{l}``; a tree with any ``*_1`` of them is read so.

The encoder's heads: ``f_heads_{i}`` is ``f_conv{i}``, a conv block
(``conv``, ``prob_fuse``) or a plain conv (``1by1``); ``s_heads_{i}_0`` is
the conv block ``sigma_conv{i}.0`` of a two-part sigma head (a conv block
and the conv ``s_heads_{i}_1`` -> ``sigma_conv{i}.1``), or the whole
``sigma_conv{i}`` of a ``feature`` sigma head, which has no second part.

The pose predictor: ``SFMPoseNet``'s conv blocks ``ConvBlock_{j}`` are
``net.{j}``; its head ``Conv1dBlock_0`` and ``Conv_0`` are
``final_layer.0`` and ``final_layer.1``, or with ``multi_hypo="None"``
(no ``Conv1dBlock_0``) ``Conv_0`` is the whole ``final_layer``.  A
``PoseNet`` (a tree with ``PoseNetFeat_0``) keeps the flax names:
``PoseNetFeat_0/ConvBlock_{j}`` -> ``feat_net.net.{j}``,
``PoseNetFeat_0/Conv1dBlock_{j}`` -> ``feat_net.emb.{j}``,
``Conv1dBlock_{j}`` -> ``blocks.{j}`` and ``Conv_{h}`` -> ``convs.{h}``.
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
)
_SFM_BLOCKS = (
    (r"pose_predictor/ConvBlock_(\d)", r"pose_predictor.net.\1"),
    (r"pose_predictor/Conv1dBlock_0", r"pose_predictor.final_layer.0"),
)
_DENSE_BLOCKS = (
    (r"pose_predictor/PoseNetFeat_0/ConvBlock_(\d)", r"pose_predictor.feat_net.net.\1"),
    (r"pose_predictor/PoseNetFeat_0/Conv1dBlock_(\d)", r"pose_predictor.feat_net.emb.\1"),
    (r"pose_predictor/Conv1dBlock_(\d)", r"pose_predictor.blocks.\1"),
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
)
_SFM_CONVS = {True: ((r"pose_predictor/Conv_0", r"pose_predictor.final_layer"),),
              False: ((r"pose_predictor/Conv_0", r"pose_predictor.final_layer.1"),)}
_DENSE_CONVS = ((r"pose_predictor/Conv_(\d)", r"pose_predictor.convs.\1"),)
_CONV_LEAVES = {"kernel": "weight", "bias": "bias"}


def _level_tables(per_level: bool):
    """The learned nets of the solve: per level (``mests_{l}`` ->
    ``mEst_func{l}``) or shared (``mests_0`` -> ``mEst_func``)."""
    idx, at = (r"(\d)", r"\1") if per_level else ("0", "")
    blocks = ((rf"mests_{idx}/ConvBlock_(\d)", rf"mEst_func{at}.net.\{1 + per_level}"),
              (rf"scalers_{idx}/ConvBlock_(\d)", rf"scaler_func{at}.net.\{1 + per_level}"))
    convs = ((rf"scalers_{idx}/Conv_0", rf"scaler_func{at}.net.4"),
             (rf"damping_nets_{idx}/FcRelu_(\d)/Dense_0",
              rf"solver_func{at}.net.\{1 + per_level}.0"))
    return blocks, convs


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: Tuple[str, ...], blocks, convs) -> str:
    name = "/".join(path)
    # the first matching pattern wins
    for table, leaves in ((blocks, _BLOCK_LEAVES), (convs, _CONV_LEAVES)):
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


def from_flax(variables: Dict[str, Any], dtype=np.float32) -> Dict[str, torch.Tensor]:
    """Convert flax ``{"params", "batch_stats"}`` into a port ``state_dict``
    of ``dtype`` (a float64 tree of gradients keeps its precision with
    ``np.float64``).

    The sigma heads are of the ``feature`` type where ``params`` holds
    ``s_heads_0_0`` but no ``s_heads_0_1``; a tree without ``params`` is
    read as two-part heads.
    """
    params = variables.get("params", {})
    enc = params.get("encoder", {})
    pose = params.get("pose_predictor", {})
    per_level = any(f"{k}_1" in params for k in ("mests", "scalers", "damping_nets"))
    level_blocks, level_convs = _level_tables(per_level)
    blocks = (*((_FEATURE_SIGMA_BLOCK,) if "s_heads_0_0" in enc and "s_heads_0_1" not in enc
                else ()), *_BLOCKS, *level_blocks)
    convs = (*_CONVS, *level_convs)
    if "PoseNetFeat_0" in pose:
        blocks, convs = (*blocks, *_DENSE_BLOCKS), (*convs, *_DENSE_CONVS)
    else:
        blocks = (*blocks, *_SFM_BLOCKS)
        convs = (*convs, *_SFM_CONVS["Conv_0" in pose and "Conv1dBlock_0" not in pose])
    state: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})):
            key = _torch_key(path, blocks, convs)
            if key in state:
                raise KeyError(f"two flax leaves map to {key!r}")
            arr = _kernel(value) if key.endswith("weight") else value
            state[key] = torch.tensor(np.asarray(arr, dtype=dtype))
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state
