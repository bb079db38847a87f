"""PyTorch/CUDA port of the deep probabilistic feature-metric tracker.

A second package beside ``deep_prob_feature_track_tpu`` (the JAX reference,
which it never imports).  The module layout mirrors the JAX package so each
counterpart is easy to find.  The bilinear gather, its training variant, its
adjoint splat and the factored JtJ reduction run as hand-written CUDA
kernels for Hopper (``ops/kernels``), with a plain PyTorch version of each
that CPU tensors take.  The presets ``feature``, ``feature_icp``, ``RGB``,
``ICP`` and ``RGB+ICP`` serve (``apps/serve.py``); ``feature`` and
``feature_icp`` train (``training/train.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
