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
launch the kernel (``csrc/splat_twohot.cu``), CPU tensors take
``splat_twohot_ref``.

Float32 sums run in fixed point, so that their bits do not depend on the
order of the adds: the kernel's atomics take its tiles in an order that
changes from run to run, and the JAX package's splats give the same bits
every run.  Each finite product ``g * w`` is formed in float32, scaled by
``2**s`` of its (b, c) channel in float64 and rounded half to even to an
int64, and the int64 sums are exact.  ``s = min(51, 62 - ceil(log2 N)) -
e``, where ``2**e`` lies above the largest finite ``|g[b, c, :]|``
(``frexp``): a sample's four corners are distinct cells and its weights lie
in [0, 1] (the fractions ``dv``, ``du`` that ``geometry/warp.py::
_corner_weights`` makes lie in [0, 1]), so a cell's sum of at most N
products stays within 2**62.  The result is that sum as a float64 times
``2**-s``, rounded to float32.  Non-finite products (NaN or Inf in g or in a weight) are
summed in float32 into the output plane, where their class (NaN, +Inf or
-Inf) does not depend on the order, and stand there in place of the
fixed-point result.  Float64 inputs, which only the plain version takes,
are summed in float64 as they come.

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
SUM_BITS = 62  # a cell's fixed-point sum stays below 2**SUM_BITS
PRODUCT_BITS = 51  # and each product's below 2**PRODUCT_BITS
ROUNDER = 1.5 * 2.0 ** 52  # x + ROUNDER rounds |x| < 2**51 half to even into its low bits

_launch = loader.launcher("splat_twohot", "splat_twohot_launch", "8P6iP")


def tile_rows(C: int) -> int:
    """Rows of 32 samples per CTA for C channels, as the launch function
    works them out: wide channel vectors take one row, so the staged
    cotangent stays small."""
    return 8 if C <= 32 else 1


def fixed_point_shift(g, top=None):
    """The exponent ``s`` [B,C] int32 of each (b, c) channel's fixed point
    for the float32 cotangent g [B,C,N]: ``min(PRODUCT_BITS, SUM_BITS -
    ceil(log2 N)) - e``, with ``frexp``'s ``e`` of the largest finite
    ``|g[b, c, :]|`` (0 where there is none), or of ``top`` [B,C] where
    the caller has it."""
    B, C, N = g.shape
    if top is None:
        top = g.abs().nan_to_num(nan=0.0, posinf=0.0)  # |g| where finite, else 0
        top = top.amax(dim=2) if N else g.new_zeros((B, C))
    bits = min(PRODUCT_BITS, SUM_BITS - max(N - 1, 0).bit_length())
    return bits - torch.frexp(top).exponent


def _pow2(e):
    """``2.0 ** e`` in float64 for int exponents ``e`` in [-1022, 1023],
    exactly: the IEEE bits built from the exponent."""
    return ((e.long() + 1023) << 52).view(torch.float64)


def splat_twohot_ref(g, v0, dv, u0, du, H: int, W: int):
    """Plain PyTorch version: ``index_add_`` of the four cell corners'
    products into the flattened [B*H*W, C] plane; in int64 fixed point for
    float32, as the kernel sums, so that the two agree bit for bit."""
    B, C, N = g.shape
    idx = v0.long().clamp(0, H - 2) * W + u0.long().clamp(0, W - 2)
    idx = (idx + torch.arange(B, device=g.device)[:, None] * (H * W)).reshape(-1)
    g_nc = g.transpose(1, 2).reshape(B * N, C)
    du = du.reshape(B * N, 1)
    dv = dv.reshape(B * N, 1)
    corners = ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)),
               (W, (1 - du) * dv), (W + 1, du * dv))
    if g.dtype != torch.float32:
        d_op = torch.zeros((B * H * W, C), dtype=g.dtype, device=g.device)
        for offset, weight in corners:
            d_op.index_add_(0, idx + offset, g_nc * weight)
        return d_op.reshape(B, H, W, C)

    # the four corners at once: products [4, B, N, C], indices [4*B*N]
    weight = torch.stack([w for _, w in corners]).view(4, B, N, 1)
    prod = g_nc.view(1, B, N, C) * weight
    cells = torch.cat([idx + offset for offset, _ in corners])
    # a non-finite product needs a non-finite g or weight (the weights lie
    # in [0, 1]), which leaves |g|'s maxima or the weights' sum non-finite;
    # where they are finite, no product is masked
    top = g.abs().amax(dim=2) if N else g.new_zeros((B, C))
    finite = bool(torch.isfinite(top.sum(dtype=torch.float64) + weight.sum()))
    shift = fixed_point_shift(g, top if finite else None)
    # the float32 product times 2**s, exact in float64, plus ROUNDER: the
    # sum's low bits are the product rounded half to even, as an int64
    rounder = torch.tensor(ROUNDER, dtype=torch.float64, device=g.device)
    fixed = torch.addcmul(rounder, prod, _pow2(shift)[:, None, :]).view(torch.int64)
    fixed = fixed.sub_(rounder.view(torch.int64))
    if not finite:  # the non-finite products' float32 sums
        ok = torch.isfinite(prod)
        d_op = torch.zeros((B * H * W, C), dtype=g.dtype, device=g.device)
        d_op.index_put_((cells,), torch.where(ok, 0.0, prod).reshape(-1, C), accumulate=True)
        fixed = torch.where(ok, fixed, 0)
    acc = torch.zeros((B * H * W, C), dtype=torch.int64, device=g.device)
    acc.index_put_((cells,), fixed.reshape(-1, C), accumulate=True)
    out = torch.mul(acc.view(B, H * W, C), _pow2(-shift)[:, None, :]).float()
    if not finite:
        out = torch.where(torch.isfinite(d_op.view(B, H * W, C)), out, d_op.view(B, H * W, C))
    return out.reshape(B, H, W, C)


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
    """Launch the CUDA kernel; every tensor must lie on the same card.  The
    int64 fixed-point plane and the channels' largest |g| live in one
    scratch tensor from PyTorch's allocator, on the current stream."""
    sg = g.shape
    if not (len(sg) == 3 and H >= 2 and W >= 2 and on_one_card(g, v0, dv, u0, du)
            and v0.shape[1] == sg[2]):
        raise_bad_args("splat_twohot_cuda", _check, g, v0, dv, u0, du, H, W)
    B, C, N = sg
    plane = B * H * W * C
    d_op = g.new_empty_strided((B, H, W, C), (H * W * C, W * C, C, 1))
    scratch = torch.empty(plane + (B * C + 1) // 2, dtype=torch.int64, device=g.device)
    acc = scratch.data_ptr()
    _launch(g.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
            d_op.data_ptr(), acc, acc + 8 * plane, B, H, W, C, N, BOX_CELLS,
            loader.raw_stream(g.get_device()))
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
