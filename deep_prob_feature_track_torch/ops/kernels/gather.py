"""Bilinear sample of a channels-last plane: CUDA kernel K1 and its plain
version.

Replaces ``deep_prob_feature_track_tpu/ops/pallas/gather.py::gather_twohot``
(``_kernel`` :204, entry :494).  The contract is the same:

    F [B,H,W,C] f32, v0/u0 [B,N] int32 corner starts in [0, size-2],
    dv/du [B,N] f32 fractional weights in [0, 1]  ->  out [B,C,N] f32

``gather_twohot`` dispatches on the tensors' device alone: CUDA tensors
launch the kernel (``csrc/gather_twohot.cu``), CPU tensors take
``gather_twohot_ref``.  Unlike the TPU kernel there is no W*C gate.
"""

from __future__ import annotations

import ctypes

import torch

from . import loader

_NAME = "gather_twohot"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def corners(F, v0, u0):
    """The four corner values ``(c00, c01, c10, c11)`` of each sample's
    cell, each [B,C,N]; ``cYX = F[b, v0+Y, u0+X, :]``."""
    B, H, W, C = F.shape
    flat = F.reshape(B, H * W, C)
    idx = v0.long().clamp(0, H - 2) * W + u0.long().clamp(0, W - 2)  # [B,N]

    def corner(offset):
        i = (idx + offset)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, i).transpose(1, 2)

    return corner(0), corner(1), corner(W), corner(W + 1)


def gather_twohot_ref(F, v0, dv, u0, du):
    """Plain PyTorch version: corner gather, then the JAX f32 path's
    ``_blend`` in the same order of operations as the kernel."""
    c00, c01, c10, c11 = corners(F, v0, u0)
    du = du[:, None, :]
    dv = dv[:, None, :]
    return c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv) + c10 * (1 - du) * dv + c11 * du * dv


def check_args(F, v0, dv, u0, du):
    if F.ndim != 4:
        raise ValueError(f"F must be [B,H,W,C], got {tuple(F.shape)}")
    B, H, W, _ = F.shape
    if H < 2 or W < 2:
        raise ValueError(f"plane {H}x{W} is smaller than one 2x2 cell")
    N = v0.shape[-1]
    for name, t, dtype in (("F", F, torch.float32), ("v0", v0, torch.int32),
                           ("dv", dv, torch.float32), ("u0", u0, torch.int32),
                           ("du", du, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t is not F and tuple(t.shape) != (B, N):
            raise ValueError(f"{name} must be [{B},{N}], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gather_twohot_cuda(F, v0, dv, u0, du):
    """Launch the CUDA kernel; every tensor must lie on the same card."""
    check_args(F, v0, dv, u0, du)
    for t in (F, v0, dv, u0, du):
        if not t.is_cuda or t.device != F.device:
            raise ValueError("gather_twohot_cuda needs CUDA tensors on one device")
    B, H, W, C = F.shape
    N = v0.shape[1]
    out = torch.empty((B, C, N), dtype=torch.float32, device=F.device)
    fn = loader.function(_NAME, "gather_twohot_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(F.device).cuda_stream
    loader.check(fn(F.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(),
                    du.data_ptr(), out.data_ptr(), B, H, W, C, N, stream), _NAME)
    loader.LAUNCHES[_NAME] += 1
    return out


def gather_twohot(F, v0, dv, u0, du):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if F.is_cuda:
        return gather_twohot_cuda(F, v0, dv, u0, du)
    check_args(F, v0, dv, u0, du)
    return gather_twohot_ref(F, v0, dv, u0, du)
