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
order of the adds: the kernel's CTAs take their bins in an order that
changes from run to run, and the JAX package's splats give the same bits
every run.  Each finite product ``g * w`` is formed in float32, scaled by
``2**s`` of its (b, c) channel in float64 and rounded half to even to an
int64, and the int64 sums are exact.  ``s = min(51, 62 - ceil(log2 N)) -
e``, where ``2**e`` lies above the largest finite ``|g[b, c, :]|``
(``frexp``): a sample's four corners are distinct cells and its weights lie
in [0, 1] (the fractions ``dv``, ``du`` that ``geometry/warp.py::
_corner_weights`` makes lie in [0, 1]), so a cell's sum of at most N
products stays within 2**62.  The result is that sum as a float64 times
``2**-s``, rounded to float32.  Non-finite products (NaN or Inf in g or
in a weight) stand in place of that result as their float32 sum: its class
(NaN, +Inf or -Inf) does not depend on the order, and the kernel keeps only
the class.  Float64 inputs, which only the plain version takes,
are summed in float64 as they come.

Because no order of the adds can move a bit, the kernel needs no
accumulator in device memory: it bins the samples by the ``TILE_H`` x
``TILE_W`` output tiles their 2x2 corner blocks touch, and one CTA sums
each tile (and group of at most ``MAX_GROUP`` channels) in registers and
writes each cell once.  A bin of more than ``SPLIT`` entries spreads over
several CTAs, which merge their int64 sums, for up to ``SLOTS_PER_IMAGE``
tiles an image.  :func:`splat_bins` computes those decisions as the kernel
makes them, and :func:`scratch_layout` the scratch they take.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import loader
from .gather import on_one_card, raise_bad_args

SUM_BITS = 62  # a cell's fixed-point sum stays below 2**SUM_BITS
PRODUCT_BITS = 51  # and each product's below 2**PRODUCT_BITS
ROUNDER = 1.5 * 2.0 ** 52  # x + ROUNDER rounds |x| < 2**51 half to even into its low bits
# the kernel's tiling (csrc/splat_twohot.cu's kTileH, kTileW, kSplit, kMaxGroup)
TILE_H, TILE_W = 8, 32  # output cells a CTA owns
SPLIT = 1024  # bin entries a CTA takes; a larger bin spreads over several CTAs
MAX_GROUP = 16  # channels a CTA sums; wider C takes several groups of CTAs
SLOTS_PER_IMAGE = 4  # merge buffers for split bins, per image

_launch = loader.launcher("splat_twohot", "splat_twohot_launch", "17P7iP")


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


def channel_groups(C: int):
    """(groups, width): the kernel sums C channels in ``groups`` groups of
    at most ``width <= MAX_GROUP`` channels, the last one possibly
    narrower."""
    groups = -(-C // MAX_GROUP)
    return groups, -(-C // groups) if C else 0


@functools.lru_cache(maxsize=64)
def scratch_layout(B: int, H: int, W: int, C: int, N: int) -> Dict[str, int]:
    """Byte offsets of the kernel's scratch regions in one allocation, and
    its ``total`` size and number of merge ``slots``: the per-tile
    ``counts``, the per-(b, c) ``top`` and the ``ctl`` counters (in that
    order: the launch zeroes them as one range), the split bins' ``parts``,
    each bin's merge slot (``slot_of``), the ``extra`` work items (a split
    bin's parts after its first), the bins' ``cursor``, the ``bins``
    themselves (at most four entries a sample) and the split tiles'
    ``merge`` sums, ``merge_cls`` class bits and ``arrivals``."""
    tiles = B * -(-H // TILE_H) * -(-W // TILE_W)
    groups, _ = channel_groups(C)
    slots = min(tiles, SLOTS_PER_IMAGE * B)
    work_cap = tiles + 4 * B * N // SPLIT  # sum over tiles of max(1, ceil(bin / SPLIT))
    cells = TILE_H * TILE_W
    sizes = (("counts", 4 * tiles), ("top", 4 * B * C), ("ctl", 16), ("parts", 4 * slots),
             ("slot_of", 4 * tiles), ("extra", 8 * (work_cap - tiles)), ("cursor", 4 * tiles),
             ("bins", 16 * B * N),
             ("merge", 8 * slots * cells * C), ("merge_cls", 4 * slots * cells * groups),
             ("arrivals", 4 * slots * groups))
    out, at = {}, 0
    for name, size in sizes:
        if name in ("extra", "merge"):
            at = -(-at // 16) * 16
        out[name] = at
        at += size
    out.update(total=-(-at // 16) * 16, slots=slots, work_cap=work_cap)
    return out


def splat_twohot_cuda(g, v0, dv, u0, du, H: int, W: int):
    """Launch the CUDA kernel; every tensor must lie on the same card.  Its
    scratch (bins, counters and the split tiles' merge buffers, laid out by
    :func:`scratch_layout`) is one tensor from PyTorch's allocator, on the
    current stream."""
    sg = g.shape
    if not (len(sg) == 3 and H >= 2 and W >= 2 and on_one_card(g, v0, dv, u0, du)
            and v0.shape[1] == sg[2]):
        raise_bad_args("splat_twohot_cuda", _check, g, v0, dv, u0, du, H, W)
    B, C, N = sg
    lay = scratch_layout(B, H, W, C, N)
    d_op = g.new_empty_strided((B, H, W, C), (H * W * C, W * C, C, 1))
    scratch = torch.empty(lay["total"] // 8, dtype=torch.int64, device=g.device)
    at = scratch.data_ptr()
    _launch(g.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
            d_op.data_ptr(), at + lay["counts"], at + lay["top"], at + lay["ctl"],
            at + lay["parts"], at + lay["slot_of"], at + lay["extra"], at + lay["cursor"],
            at + lay["bins"], at + lay["merge"], at + lay["merge_cls"], at + lay["arrivals"],
            B, H, W, C, N,
            lay["slots"], lay["work_cap"], loader.raw_stream(g.get_device()))
    return d_op


def splat_twohot(g, v0, dv, u0, du, H: int, W: int):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if g.is_cuda:
        return splat_twohot_cuda(g, v0, dv, u0, du, H, W)
    _check(g, v0, dv, u0, du, H, W)
    return splat_twohot_ref(g, v0, dv, u0, du, H, W)


def splat_bins(v0, u0, H: int, W: int, C: int) -> Dict[str, object]:
    """K3's binning for corner starts v0, u0 [B,N], computed as the kernel
    decides it.  A sample's clamped start (v, u) puts it in the bin of every
    ``TILE_H`` x ``TILE_W`` tile that one of its corners (v or v+1, u or
    u+1) lies in.  Returns ``counts`` [B,TY,TX] (each bin's entries),
    ``split`` (the bins over ``SPLIT`` entries that spread over CTAs: the
    first ``slots`` of them in tile order), ``parts`` (CTAs a tile and
    channel group takes), ``groups`` and ``width`` (:func:`channel_groups`),
    ``ctas`` (work items: parts times groups), ``cross_share`` (the share of
    samples binned beyond their home tile too) and ``split_share`` (the
    share of tiles split)."""
    B, N = v0.shape
    TY, TX = -(-H // TILE_H), -(-W // TILE_W)
    v = v0.long().clamp(0, H - 2)
    u = u0.long().clamp(0, W - 2)
    ty0, tx0, ty1, tx1 = v // TILE_H, u // TILE_W, (v + 1) // TILE_H, (u + 1) // TILE_W
    down, right = ty1 != ty0, tx1 != tx0
    image = torch.arange(B, device=v.device)[:, None] * (TY * TX)
    counts = torch.zeros(B * TY * TX, dtype=torch.long, device=v.device)
    for ty, tx, keep in ((ty0, tx0, None), (ty0, tx1, right), (ty1, tx0, down),
                         (ty1, tx1, down & right)):
        t = image + ty * TX + tx
        t = t.reshape(-1) if keep is None else t[keep]
        counts.index_add_(0, t, torch.ones_like(t))
    over = counts > SPLIT
    split = over & (torch.cumsum(over, 0) - over.long() < scratch_layout(B, H, W, C, N)["slots"])
    parts = torch.where(split, -(-counts // SPLIT), torch.ones_like(counts))
    groups, width = channel_groups(C)
    return {"counts": counts.view(B, TY, TX), "split": split.view(B, TY, TX),
            "parts": parts.view(B, TY, TX), "groups": groups, "width": width,
            "ctas": int(parts.sum()) * groups,
            "cross_share": float((down | right).double().mean()) if N else 0.0,
            "split_share": float(split.double().mean())}
