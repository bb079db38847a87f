"""Finding the first non-finite value of a step.

Counterpart of ``deep_prob_feature_track_tpu/utils/debug.py``.  There,
``checkify.float_checks`` makes a jitted step raise at the first NaN or Inf
that it produces.  Here :func:`checked` wraps a step so that it raises
:class:`NonFiniteError` naming where a non-finite value first appeared: the
module whose forward output first held one (forward hooks on every module
of the given root), else the autograd node whose backward first returned
one (``torch.autograd.detect_anomaly``).  Each hook reads its output on the
host, so a checked step runs far slower; the train CLI's ``--debug_nan``
turns it on.  Nothing catches the error.
"""

from __future__ import annotations

from typing import Callable, List

import torch
from torch import nn


class NonFiniteError(FloatingPointError):
    """A step produced a NaN or an Inf; the message names where."""


def _non_finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return any(_non_finite(o) for o in out)
    if isinstance(out, dict):
        return any(_non_finite(o) for o in out.values())
    return False


def checked(fn: Callable, root: nn.Module) -> Callable:
    """Wrap ``fn`` (a step over ``root``'s modules) so that it raises
    :class:`NonFiniteError` at the first non-finite value it produces.

    :param root: the modules to watch (the tracker); the first module in
        call order whose forward output is not finite is named
    """

    def wrapper(*args, **kwargs):
        first: List[str] = []
        names = {m: name or type(root).__name__ for name, m in root.named_modules()}

        def hook(module, _inputs, output):
            if not first and _non_finite(output):
                first.append(f"{names[module]} ({type(module).__name__})")

        handles = [m.register_forward_hook(hook) for m in names]
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                try:
                    out = fn(*args, **kwargs)
                except RuntimeError as e:
                    if "nan values" not in str(e):  # not anomaly mode's report
                        raise
                    if first:
                        raise NonFiniteError(
                            f"non-finite value first produced by module {first[0]}") from e
                    raise NonFiniteError(f"non-finite gradient: {e}") from e
        finally:
            for h in handles:
                h.remove()
        if first:
            raise NonFiniteError(f"non-finite value first produced by module {first[0]}")
        return out

    return wrapper
