"""Bilinear sample of a channels-last plane: CUDA kernel K1 and its plain
version.

Replaces ``deep_prob_feature_track_tpu/ops/pallas/gather.py::gather_twohot``
(``_kernel`` :204, entry :494).  The contract is the same:

    F [B,H,W,C] f32, v0/u0 [B,N] int32 corner starts in [0, size-2],
    dv/du [B,N] f32 fractional weights in [0, 1]  ->  out [B,C,N] f32

``gather_twohot`` dispatches on the tensors' device alone: CUDA tensors
launch the kernel (``csrc/gather_twohot.cu``: a CTA takes a run of 256
consecutive samples, its lanes cooperate over the channels, and a shared
tile turns the result to [C, 256] for coalesced stores), CPU tensors take
``gather_twohot_ref``.  Unlike the TPU kernel there is no W*C gate.
"""

from __future__ import annotations

import torch

from . import loader

_launch = loader.launcher("gather_twohot", "gather_twohot_launch", "6P5iP")
_F32, _I32 = torch.float32, torch.int32


def corners(F, v0, u0):
    """The four corner values ``(c00, c01, c10, c11)`` of each sample's
    cell, each [B,C,N] and contiguous: the kernels' output layout, so that
    the ops after a plain gather see the strides, and round as, they do
    after the kernel; ``cYX = F[b, v0+Y, u0+X, :]``."""
    B, H, W, C = F.shape
    flat = F.reshape(B, H * W, C)
    idx = v0.long().clamp(0, H - 2) * W + u0.long().clamp(0, W - 2)  # [B,N]

    def corner(offset):
        i = (idx + offset)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, i).transpose(1, 2).contiguous()

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


def on_one_card(x, v0, dv, u0, du, maps_ndim: int = 2) -> bool:
    """The argument contract that the CUDA kernels K1-K5 share: ``x`` (the
    plane, or K3's cotangent) float32, the maps v0/u0 int32 and dv/du
    float32 of one shape [B, ...] with ``maps_ndim`` dims and x's B, every
    tensor contiguous and on one card.  ``x``'s own shape is the caller's
    to check, before this.  One predicate that reads each attribute once."""
    s, d = v0.shape, x.get_device()
    return (x.is_cuda and len(s) == maps_ndim and s[0] == x.shape[0]
            and dv.shape == s and u0.shape == s and du.shape == s
            and x.dtype is _F32 and v0.dtype is _I32 and dv.dtype is _F32
            and u0.dtype is _I32 and du.dtype is _F32
            and x.is_contiguous() and v0.is_contiguous() and dv.is_contiguous()
            and u0.is_contiguous() and du.is_contiguous()
            and v0.get_device() == d and dv.get_device() == d
            and u0.get_device() == d and du.get_device() == d)


def cuda_dims(F, v0, dv, u0, du, maps_ndim: int = 2):
    """``F.shape + v0.shape[1:]`` -- ``(B, H, W, C, N)`` for K1 and K2,
    ``(B, H, W, C, Hs, Ws)`` for K4 and K5 (``maps_ndim=3``) -- when the
    arguments are what those kernels take: ``check_args``'s conditions and
    every tensor on one card.  Else None."""
    sF = F.shape
    if len(sF) == 4 and sF[1] >= 2 and sF[2] >= 2 and on_one_card(F, v0, dv, u0, du, maps_ndim):
        return (*sF, *v0.shape[1:])
    return None


def raise_bad_args(name, check, *args):
    """Raise what ``check(*args)`` finds wrong with arguments that the fast
    predicate refused, else that they are not CUDA tensors on one card."""
    check(*args)
    raise ValueError(f"{name} needs CUDA tensors on one device")


def gather_twohot_cuda(F, v0, dv, u0, du):
    """Launch the CUDA kernel; every tensor must lie on the same card."""
    dims = cuda_dims(F, v0, dv, u0, du)
    if dims is None:
        raise_bad_args("gather_twohot_cuda", check_args, F, v0, dv, u0, du)
    B, H, W, C, N = dims
    out = F.new_empty_strided((B, C, N), (C * N, N, 1))  # the cheapest allocation call
    _launch(F.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
            out.data_ptr(), B, H, W, C, N, loader.raw_stream(F.get_device()))
    return out


def gather_twohot(F, v0, dv, u0, du):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if F.is_cuda:
        return gather_twohot_cuda(F, v0, dv, u0, du)
    check_args(F, v0, dv, u0, du)
    return gather_twohot_ref(F, v0, dv, u0, du)
