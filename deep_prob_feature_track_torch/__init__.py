"""PyTorch/CUDA port of the deep probabilistic feature-metric tracker.

A second package beside ``deep_prob_feature_track_tpu`` (the JAX reference,
which it never imports).  The module layout mirrors the JAX package so each
counterpart is easy to find.  The bilinear gather, its training variant, its
adjoint splat and the factored JtJ reduction run as hand-written CUDA
kernels for Hopper (``ops/kernels``), with a plain PyTorch version of each
that CPU tensors take.  The presets ``feature``, ``feature_icp``, ``RGB``,
``ICP``, ``RGB+ICP`` and ``DeepIC`` serve (``apps/serve.py``); the learned
ones train (``training/train.py``).  ``apps/evaluate.py`` and
``apps/train.py`` evaluate and train them from TUM-format RGB-D sequences
on disk (``data/``, on numpy and the standard library alone); the other
apps (the non-learned baselines, keyframe VO, trajectory evaluation,
checkpoint import, the convergence basin) run on the same code.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
