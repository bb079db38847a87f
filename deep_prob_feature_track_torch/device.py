"""Device resolution (``cuda`` by default, ``cpu`` only when asked for) and
the float32 policy of every entry point."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the ``torch.device`` an entry point should run on.

    Raises when ``cuda`` is asked for on a machine without a card: the port
    never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def set_float32_policy() -> None:
    """Full float32 convolutions and matmuls (no TF32), and cuDNN's
    deterministic algorithms: its default backward algorithms add with
    atomics, and with them a training step's bits change from run to run
    (with them off and K3 in fixed point, a step gives the same bits every
    run, as the JAX package does)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
