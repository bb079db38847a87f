"""Basic NN building blocks (conv + BN + ELU, linear + ReLU).

Counterpart of ``deep_prob_feature_track_tpu/models/layers.py``.  Blocks
are ``nn.Sequential``s so their ``state_dict`` keys are the reference
layout ``{0: conv, 1: batchnorm}``.  Padding is ``(k-1)//2 + d - 1``;
with BatchNorm the conv has no bias.  BatchNorm follows flax in training
(:class:`FlaxBatchNormMixin`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum, current as current_mesh
from ..utils.remat import recomputing

# CIFAR-style color statistics
RGB_MEAN = (0.4914, 0.4822, 0.4465)
RGB_STD = (0.2023, 0.1994, 0.2010)


def color_normalize_nchw(color: torch.Tensor) -> torch.Tensor:
    """Normalize an RGB image [B,3,H,W] with CIFAR statistics."""
    mean = torch.tensor(RGB_MEAN, dtype=color.dtype, device=color.device).reshape(1, 3, 1, 1)
    std = torch.tensor(RGB_STD, dtype=color.dtype, device=color.device).reshape(1, 3, 1, 1)
    return (color - mean) / std


class FlaxBatchNormMixin:
    """BatchNorm with flax's training semantics.

    In training the output is normalized with the batch mean and the biased
    batch variance (as torch does), and the running statistics move as
    flax's ``momentum=0.9`` moves them: ``0.9 * running + 0.1 * batch``,
    with the BIASED batch variance, where torch's own update takes the
    unbiased one.  Eval mode is torch's.

    While a mesh is active (``parallel/mesh.py``), the statistics are those
    of the global batch, as in a JAX mesh step: the sums the mean and the
    variance come from are all-reduced over the ranks (the shards are of
    equal size), and the gradient flows back through the reduction.

    Where a checkpoint replays the forward in the backward
    (``utils/remat.py``), the running statistics stay as the forward left
    them: they move once a forward, as under flax's ``nn.remat``.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.ndim)]
        mesh = current_mesh()
        replay = recomputing()
        if mesh is not None and mesh.world > 1:
            out, mean, var = self._global_batch_norm(x, dims, mesh)
        else:
            if not replay:
                with torch.no_grad():
                    var, mean = torch.var_mean(x, dim=dims, correction=0)
            out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if replay:
            return out
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean.detach())
            self.running_var.mul_(keep).add_(self.momentum * var.detach())
            self.num_batches_tracked.add_(1)
        return out

    def _global_batch_norm(self, x: torch.Tensor, dims, mesh):
        """The normalized ``x`` and the global batch's mean and biased
        variance (two passes: the mean, then the centred squares)."""
        shape = [1, -1] + [1] * (x.ndim - 2)
        count = mesh.world * (x.numel() // x.shape[1])
        mean = all_reduce_sum(x.sum(dim=dims), mesh) / count
        centred = x - mean.reshape(shape)
        var = all_reduce_sum((centred * centred).sum(dim=dims), mesh) / count
        out = centred * torch.rsqrt(var + self.eps).reshape(shape)
        return out * self.weight.reshape(shape) + self.bias.reshape(shape), mean, var


class BatchNorm2d(FlaxBatchNormMixin, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update."""


class BatchNorm1d(FlaxBatchNormMixin, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running-statistics update."""


class ConvBlock(nn.Sequential):
    """Conv2d + BatchNorm2d(eps 1e-5) + ELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, stride: int = 1):
        pad = (kernel_size - 1) // 2 + dilation - 1
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=pad,
                      dilation=dilation, bias=False),
            BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            nn.ELU(),
        )


class Conv1dBlock(nn.Sequential):
    """Conv1d + BatchNorm1d(eps 1e-5) + ELU over [B, C, N]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1):
        super().__init__(
            nn.Conv1d(in_channels, out_channels, kernel_size,
                      padding=(kernel_size - 1) // 2, bias=False),
            BatchNorm1d(out_channels, eps=1e-5, momentum=0.1),
            nn.ELU(),
        )


class XavierConv2d(nn.Conv2d):
    """A plain Conv2d (with bias) whose kernel :func:`seeded_init_` draws
    xavier-uniform, as the JAX package's ``1by1`` feature head does."""


class FcRelu(nn.Sequential):
    """Linear + ReLU; the reference layout ``{0: linear}``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(nn.Linear(in_features, out_features), nn.ReLU())


def seeded_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every conv, linear and BatchNorm below ``module`` from
    ``generator``.

    Follows the JAX package's initializers: xavier-uniform kernels in conv
    blocks and :class:`XavierConv2d`, lecun-normal kernels in the other
    plain convs and linears (flax ``Dense``), zero biases, BatchNorm scale
    1, bias 0, running mean 0 and variance 1.
    """
    xavier = {id(m[0]) for m in module.modules() if isinstance(m, (ConvBlock, Conv1dBlock))}
    xavier |= {id(m) for m in module.modules() if isinstance(m, XavierConv2d)}
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = m.weight
            receptive = math.prod(w.shape[2:])
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            with torch.no_grad():
                if id(m) in xavier:
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    w.uniform_(-bound, bound, generator=generator)
                else:
                    # flax lecun_normal: truncated normal (+-2 std), std 1/sqrt(fan_in)
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
