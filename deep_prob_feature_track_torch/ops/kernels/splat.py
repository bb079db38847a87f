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

The kernel reads the samples as rows of ``W`` (the tracker samples each
plane at its own size) and gives each CTA a tile of ``tile_rows(C)`` x 32 of
them.  A tile whose clamped corner box, ``(vmax - vmin + 2) x
(umax - umin + 2)`` cells, has at most ``BOX_CELLS`` cells sums each cell's
contributions in shared memory and adds each sum once (staged); any other
tile adds straight into the plane (global).  :func:`splat_staged_share`
computes that decision as the kernel does.
"""

from __future__ import annotations

import torch

from . import loader
from .gather import on_one_card, raise_bad_args

BOX_CELLS = 1024  # corner-box cells a CTA may stage (4 KB of list heads)

_launch = loader.launcher("splat_twohot", "splat_twohot_launch", "6P6iP")


def tile_rows(C: int) -> int:
    """Rows of 32 samples per CTA for C channels, as the launch function
    works them out: wide channel vectors take one row, so the staged
    cotangent stays small."""
    return 8 if C <= 32 else 1


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
    sg = g.shape
    if not (len(sg) == 3 and H >= 2 and W >= 2 and on_one_card(g, v0, dv, u0, du)
            and v0.shape[1] == sg[2]):
        raise_bad_args("splat_twohot_cuda", _check, g, v0, dv, u0, du, H, W)
    B, C, N = sg
    d_op = g.new_empty_strided((B, H, W, C), (H * W * C, W * C, C, 1))
    _launch(g.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
            d_op.data_ptr(), B, H, W, C, N, BOX_CELLS, loader.raw_stream(g.get_device()))
    return d_op


def splat_twohot(g, v0, dv, u0, du, H: int, W: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if g.is_cuda:
        return splat_twohot_cuda(g, v0, dv, u0, du, H, W)
    _check(g, v0, dv, u0, du, H, W)
    return splat_twohot_ref(g, v0, dv, u0, du, H, W)


def splat_staged_share(v0, u0, H: int, W: int, C: int) -> float:
    """Share of K3's CTAs that accumulate in shared memory for corner starts
    v0, u0 [B,N], computed as the kernel decides it: per tile of
    ``tile_rows(C)`` x 32 samples of the [N/W, W] view of one image, the
    clamped starts' box ``(vmax - vmin + 2) x (umax - umin + 2)`` cells
    against ``BOX_CELLS``.  Tiles past the last sample do not count."""
    B, N = v0.shape
    th = tile_rows(C)
    rows = -(-N // W)
    rows = -(-rows // th) * th  # sample rows, padded to whole tiles
    cols = -(-W // 32) * 32

    def tiles(m, hi, fill):
        grid = torch.full((B, rows * W), fill, dtype=torch.long, device=m.device)
        grid[:, :N] = m.long().clamp(0, hi)
        padded = torch.full((B, rows, cols), fill, dtype=torch.long, device=m.device)
        padded[:, :, :W] = grid.reshape(B, rows, W)
        return padded.reshape(B, rows // th, th, cols // 32, 32)

    far = max(H, W) + 1
    vlo, ulo = (tiles(m, hi, far).amin(dim=(2, 4)) for m, hi in ((v0, H - 2), (u0, W - 2)))
    vhi, uhi = (tiles(m, hi, -far).amax(dim=(2, 4)) for m, hi in ((v0, H - 2), (u0, W - 2)))
    live = vhi >= 0
    staged = live & ((vhi - vlo + 2) * (uhi - ulo + 2) <= BOX_CELLS)
    return staged.sum().item() / live.sum().item()
