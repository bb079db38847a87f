"""Operand cotangent of the bilinear sample: CUDA kernel K3 and its plain
version.

Replaces ``deep_prob_feature_track_tpu/ops/pallas/gather.py::splat_twohot``
(``_splat_kernel`` :283, entry :400) and the XLA two-hot splat
``geometry/warp.py::_splat_twohot`` it falls back to.  The function is the
adjoint of K1:

    g [B,C,N] f32, v0/u0 [B,N] int32, dv/du [B,N] f32, (H, W)
        ->  d_op [B,H,W,C] f32,
    d_op[b,y,x,c] = sum_n V[b,n,y] U[b,n,x] g[b,c,n]

The cotangent comes in the [B,C,N] layout that K1/K2 produce and the
autograd backward hands over (the TPU kernel takes [B,N,C]).
``splat_twohot`` dispatches on the tensors' device alone: CUDA tensors
launch the kernel (``csrc/splat_twohot.cu``, float atomics: the summation
order changes from run to run), CPU tensors take ``splat_twohot_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import loader

_NAME = "splat_twohot"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def splat_twohot_ref(g, v0, dv, u0, du, H: int, W: int):
    """Plain PyTorch version: one ``index_add_`` per cell corner into the
    flattened [B*H*W, C] plane."""
    B, C, N = g.shape
    idx = v0.long().clamp(0, H - 2) * W + u0.long().clamp(0, W - 2)
    idx = (idx + torch.arange(B, device=g.device)[:, None] * (H * W)).reshape(-1)
    g_nc = g.transpose(1, 2).reshape(B * N, C)
    du = du.reshape(B * N, 1)
    dv = dv.reshape(B * N, 1)
    d_op = torch.zeros((B * H * W, C), dtype=g.dtype, device=g.device)
    for offset, weight in ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)),
                           (W, (1 - du) * dv), (W + 1, du * dv)):
        d_op.index_add_(0, idx + offset, g_nc * weight)
    return d_op.reshape(B, H, W, C)


def _check(g, v0, dv, u0, du, H, W):
    if g.ndim != 3:
        raise ValueError(f"g must be [B,C,N], got {tuple(g.shape)}")
    if H < 2 or W < 2:
        raise ValueError(f"plane {H}x{W} is smaller than one 2x2 cell")
    B, _, N = g.shape
    for name, t, dtype in (("g", g, torch.float32), ("v0", v0, torch.int32),
                           ("dv", dv, torch.float32), ("u0", u0, torch.int32),
                           ("du", du, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t is not g and tuple(t.shape) != (B, N):
            raise ValueError(f"{name} must be [{B},{N}], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def splat_twohot_cuda(g, v0, dv, u0, du, H: int, W: int):
    """Launch the CUDA kernel; every tensor must lie on the same card."""
    _check(g, v0, dv, u0, du, H, W)
    for t in (g, v0, dv, u0, du):
        if not t.is_cuda or t.device != g.device:
            raise ValueError("splat_twohot_cuda needs CUDA tensors on one device")
    B, C, N = g.shape
    d_op = torch.empty((B, H, W, C), dtype=torch.float32, device=g.device)
    fn = loader.function(_NAME, "splat_twohot_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    loader.check(fn(g.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
                    d_op.data_ptr(), B, H, W, C, N, stream), _NAME)
    loader.LAUNCHES[_NAME] += 1
    return d_op


def splat_twohot(g, v0, dv, u0, du, H: int, W: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if g.is_cuda:
        return splat_twohot_cuda(g, v0, dv, u0, du, H, W)
    _check(g, v0, dv, u0, du, H, W)
    return splat_twohot_ref(g, v0, dv, u0, du, H, W)
