"""The training memory modes' state: rematerialization, and the bfloat16
derivative maps of the trained gathers.

Rematerialization runs a region of the training forward under a
checkpoint, so that the backward recomputes its activations instead of
keeping them: the counterpart of the JAX package's ``jax.checkpoint`` over
a Gauss-Newton iteration (``DPFT_TRAIN_LOOP=scan_remat``) and ``nn.remat``
over the encoder (``DPFT_REMAT_ENCODER=1``).  :func:`checkpointed` is
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
records the graph as it would without it and drops the tensors the
backward reads; the backward replays the region's ops on the same inputs,
which gives the same bits on every op the step runs (the kernels and
cuDNN's deterministic algorithms are deterministic), so the gradients are
those of the region run without a checkpoint.

A replay must not move state a second time: :func:`recomputing` is true
while a replay runs, and BatchNorm (``models/layers.py``) leaves its
running statistics alone then, as flax's ``nn.remat`` does.

Within :func:`bf16_maps` every gather that autograd records keeps its
derivative maps in bfloat16 (``geometry/warp.py::warp_operand`` reads
:func:`keeps_bf16_maps`; the JAX package's ``DPFT_BF16_RESIDUALS=1``).  A
replay keeps the setting of the forward it replays, which has ended by
then.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

# the autograd engine may replay on one of its own threads: the state is
# that thread's
_state = threading.local()


def recomputing() -> bool:
    """Whether this thread is replaying a checkpointed region."""
    return getattr(_state, "depth", 0) > 0


def keeps_bf16_maps() -> bool:
    """Whether this thread's trained gathers keep bfloat16 maps."""
    return getattr(_state, "bf16", False)


@contextlib.contextmanager
def bf16_maps(enabled: bool = True):
    """Within: the trained gathers keep bfloat16 maps where ``enabled``."""
    prev = keeps_bf16_maps()
    _state.bf16 = enabled
    try:
        yield
    finally:
        _state.bf16 = prev


@contextlib.contextmanager
def _replay(bf16: bool):
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        with bf16_maps(bf16):
            yield
    finally:
        _state.depth -= 1


def _contexts():
    # called as the forward enters the region: the replay's context keeps
    # the forward's bf16 setting
    return contextlib.nullcontext(), _replay(keeps_bf16_maps())


def checkpointed(fn, *args, enabled: bool = True):
    """``fn(*args)``, under a checkpoint where ``enabled`` and autograd
    records (else plainly).  ``fn`` draws no random numbers, so no RNG
    state is kept for the replay."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts,
                      preserve_rng_state=False)
