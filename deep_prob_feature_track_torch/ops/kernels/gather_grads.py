"""Training-forward bilinear sample with derivative maps: CUDA kernel K2 and
its plain version.

Replaces ``deep_prob_feature_track_tpu/ops/pallas/gather.py::gather_twohot_grads``
(``_grads_kernel`` :234, entry :514).  The contract is K1's, with two more
outputs:

    F [B,H,W,C] f32, v0/u0 [B,N] int32, dv/du [B,N] f32
        ->  (out, gx, gy) each [B,C,N] f32

``out`` is K1's blend, bit for bit; ``gx`` and ``gy`` are the within-cell
derivatives along u and v that the gather's backward contracts with the
output cotangent.  ``gather_twohot_grads`` dispatches on the tensors'
device alone: CUDA tensors launch the kernel (``csrc/gather_twohot.cu``
with ``GRADS``: K1's runs of consecutive samples, lanes over the channels
and one shared tile per output for coalesced stores), CPU tensors take
``gather_twohot_grads_ref``.

With ``bf16=True`` (the training mode ``bf16_residuals``, the JAX
package's ``DPFT_BF16_RESIDUALS=1``) gx and gy are bfloat16, each rounded
once to nearest even from its float32 value, at the kernel's store: the
bits of ``gx_f32.to(torch.bfloat16)``.  ``out`` stays float32.
"""

from __future__ import annotations

import torch

from . import loader
from .gather import check_args, corners, cuda_dims, raise_bad_args

_launch = loader.launcher("gather_twohot_grads", "gather_twohot_grads_launch", "8P6iP")


def gather_twohot_grads_ref(F, v0, dv, u0, du, bf16: bool = False):
    """Plain PyTorch version: the corner gather, ``_blend`` and the gx/gy
    formulas of the JAX ``_corner_grads_oneshot``, in that order; with
    ``bf16`` gx and gy cast to bfloat16 after."""
    c00, c01, c10, c11 = corners(F, v0, u0)
    du = du[:, None, :]
    dv = dv[:, None, :]
    out = c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv) + c10 * (1 - du) * dv + c11 * du * dv
    gx = (c01 - c00) * (1 - dv) + (c11 - c10) * dv
    gy = (c10 - c00) * (1 - du) + (c11 - c01) * du
    if bf16:
        return out, gx.to(torch.bfloat16), gy.to(torch.bfloat16)
    return out, gx, gy


def gather_twohot_grads_cuda(F, v0, dv, u0, du, bf16: bool = False):
    """Launch the CUDA kernel; every tensor must lie on the same card."""
    dims = cuda_dims(F, v0, dv, u0, du)
    if dims is None:
        raise_bad_args("gather_twohot_grads_cuda", check_args, F, v0, dv, u0, du)
    B, H, W, C, N = dims
    # three separate buffers: the backward keeps gx and gy alive, not out
    maps = torch.bfloat16 if bf16 else torch.float32
    out = F.new_empty((B, C, N))
    gx, gy = F.new_empty((B, C, N), dtype=maps), F.new_empty((B, C, N), dtype=maps)
    _launch(F.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
            out.data_ptr(), gx.data_ptr(), gy.data_ptr(), B, H, W, C, N, int(bf16),
            loader.raw_stream(F.get_device()))
    return out, gx, gy


def gather_twohot_grads(F, v0, dv, u0, du, bf16: bool = False):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if F.is_cuda:
        return gather_twohot_grads_cuda(F, v0, dv, u0, du, bf16)
    check_args(F, v0, dv, u0, du)
    return gather_twohot_grads_ref(F, v0, dv, u0, du, bf16)
