"""Bilinear sample staged per output tile: CUDA kernels K4 (``gather_tiles``)
and K5 (``gather_tiles_grads``), their plain versions, and the route that
picks them.

Replaces ``deep_prob_feature_track_tpu/ops/pallas/gather_tiles.py``:
``gather_tiles`` (entry :481, ``_kernel`` :177 with ``grads=False``) and
``gather_tiles_grads`` (entry :504, the same ``_kernel`` with
``grads=True``).  The contract is the JAX entries':

    F [B,H,W,C] f32, v0/u0 [B,Hs,Ws] int32 corner starts in [0, size-2],
    dv/du [B,Hs,Ws] f32 fractional weights
        ->  out [B,C,Hs*Ws] f32 in raster sample order
            (the grads variant: (out, gx, gy), each [B,C,Hs*Ws])

The functions are K1's and K2's on a 2-D sample grid, so the plain versions
flatten the maps and call K1's and K2's plain versions.  The kernels
(``csrc/gather_tiles.cu``) take the sample grid in tiles of ``rows x
TILE_W`` samples; a tile stages its samples' corner box of the plane in
shared memory when the box fits, and reads the corners from device memory
when it does not.  K4's persistent CTAs walk tiles of :func:`tile_rows`
rows through a ring of four ``BOX_FLOATS`` box buffers, each filled
asynchronously with one copy of a fixed window of the plane; K5 gives each CTA one ``GRADS_TILE_H`` row tile and
``GRADS_BOX_FLOATS`` floats.  :func:`staged_share` and
:func:`grads_staged_share` count the tiles that stage as the kernels
decide it.  ``gather_tiles`` and ``gather_tiles_grads`` dispatch on the
tensors' device alone: CUDA tensors launch a kernel, CPU tensors take the
plain version.

:func:`use_tiles` is the JAX package's route: the warp takes these kernels
exactly where the JAX package would take its tile kernels.
"""

from __future__ import annotations

import functools

import torch

from . import loader
from .gather import cuda_dims, gather_twohot_ref, raise_bad_args
from .gather_grads import gather_twohot_grads_ref

TILE_W = 32  # one warp per tile row: coalesced coordinate loads and stores
# K4: four ring buffers of 44 KB (with the warps' coordinate rings 217 KB of
# shared memory: one CTA an SM); a multiple of 32 floats, so that every
# buffer starts on 128 bytes, as TMA copies need
BOX_FLOATS = 11264
MAX_TILE_ROWS = 16  # one consumer warp per tile row
# K5: 8-row tiles, 26 KB of shared memory per CTA
GRADS_TILE_H, GRADS_BOX_FLOATS = 8, 6656


def window_chunks(C: int) -> int:
    """128-byte chunks a K4 window row spans: those that a run of
    ``TILE_W + 3`` cells can reach from any float of its first chunk."""
    return ((TILE_W + 3) * C + 31 + 31) // 32


@functools.lru_cache(maxsize=None)
def tile_rows(C: int) -> int:
    """K4's rows per tile at C channels: the most, up to ``MAX_TILE_ROWS``,
    whose window (the tile's rows and three more, for the cells' second row
    and two cells of motion) fits a buffer."""
    th = MAX_TILE_ROWS
    while th > 1 and (th + 3) * 32 * window_chunks(C) > BOX_FLOATS:
        th //= 2
    return th


def has_window(W: int, C: int) -> bool:
    """Whether K4 copies windows of a plane [., ., W, C]: its rows are whole
    128-byte chunks and the window fits a buffer."""
    return W * C % 32 == 0 and (tile_rows(C) + 3) * 32 * window_chunks(C) <= BOX_FLOATS


_LAUNCH = {name: loader.launcher(name, f"{name}_launch", "8P8iP")
           for name in ("gather_tiles", "gather_tiles_grads")}
# kernel -> (tile rows, floats of a box buffer) at C channels
_TILING = {"gather_tiles": lambda C: (tile_rows(C), BOX_FLOATS),
           "gather_tiles_grads": lambda C: (GRADS_TILE_H, GRADS_BOX_FLOATS)}


# ------------------------------------------------------------------ route
#
# Copies of the arithmetic of the JAX package's gates, without the dtype and
# TPU-backend checks: ``ops/pallas/gather.py::default_config`` (:68-102) and
# ``supported`` (:124-131) for the full-plane kernels,
# ``ops/pallas/gather_tiles.py::default_tile_config`` (:72-123) and
# ``supported`` (:126-134) for the tile kernels.


def _full_plane_supported(kind: str, H: int, W: int, C: int) -> bool:
    """Whether the JAX package's full-plane kernel (K1 for eval, K2 for
    grads) takes an operand [., H, W, C]."""
    if H < 2 or W < 2:
        return False
    WC = W * C
    if H * WC * 4 > 4 * 1024 * 1024:  # the plane must fit in VMEM
        return False
    return WC <= (4000 if kind == "eval" else 2720)  # probe-calibrated lane caps


def _tiles_supported(kind: str, H: int, W: int, C: int, Hs: int, Ws: int) -> bool:
    """Whether the JAX package's tile kernel takes an operand [., H, W, C]
    sampled on an Hs x Ws grid (16x16 tiles, 64x64 slabs)."""
    if H < 2 or W < 2 or C < 1 or C > 128:
        return False
    Cp = max(8, 1 << (C - 1).bit_length())
    if kind == "grads" and Cp > 16:
        return False
    th = tw = 16
    band_v = band_u = 64
    q = 128 // Cp
    if Hs < th or Ws < tw or H < band_v or W < band_u:
        return False
    # the quantized start grid must let the band cover the last row/column
    if ((H - band_v) // 8) * 8 + band_v < H or ((W - band_u) // q) * q + band_u < W:
        return False
    return th * tw * band_u * Cp <= (524_288 if kind == "grads" else 696_320)


def use_tiles(kind: str, H: int, W: int, C: int, Hs: int, Ws: int) -> bool:
    """True exactly where the JAX package samples an operand [., H, W, C]
    on an Hs x Ws grid with its tile kernel: ``gather_tiles`` for
    ``kind="eval"``, ``gather_tiles_grads`` for ``kind="grads"`` (the
    training forward).  Elsewhere the port takes K1 / K2, where the JAX
    package takes them or its XLA gather."""
    if kind not in ("eval", "grads"):
        raise ValueError(f"kind must be 'eval' or 'grads', got {kind!r}")
    return not _full_plane_supported(kind, H, W, C) and _tiles_supported(kind, H, W, C, Hs, Ws)


# ------------------------------------------------------ kernels and twins


def _flat(*maps):
    return [m.reshape(m.shape[0], -1) for m in maps]


def gather_tiles_ref(F, v0, dv, u0, du):
    """Plain PyTorch version: K1's plain version on the flattened maps."""
    return gather_twohot_ref(F, *_flat(v0, dv, u0, du))


def gather_tiles_grads_ref(F, v0, dv, u0, du):
    """Plain PyTorch version: K2's plain version on the flattened maps."""
    return gather_twohot_grads_ref(F, *_flat(v0, dv, u0, du))


def check_args(F, v0, dv, u0, du):
    if F.ndim != 4:
        raise ValueError(f"F must be [B,H,W,C], got {tuple(F.shape)}")
    B, H, W, _ = F.shape
    if H < 2 or W < 2:
        raise ValueError(f"plane {H}x{W} is smaller than one 2x2 cell")
    if v0.ndim != 3:
        raise ValueError(f"v0 must be [B,Hs,Ws], got {tuple(v0.shape)}")
    shape = (B, *v0.shape[1:])
    for name, t, dtype in (("F", F, torch.float32), ("v0", v0, torch.int32),
                           ("dv", dv, torch.float32), ("u0", u0, torch.int32),
                           ("du", du, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t is not F and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name, n_out, F, v0, dv, u0, du):
    """Check the arguments, allocate ``n_out`` outputs [B,C,Hs*Ws] and
    launch kernel ``name``; returns the outputs."""
    dims = cuda_dims(F, v0, dv, u0, du, maps_ndim=3)
    if dims is None:
        raise_bad_args(f"{name}_cuda", check_args, F, v0, dv, u0, du)
    B, H, W, C, Hs, Ws = dims
    # separate buffers: the training backward keeps gx and gy alive, not out
    outs = [F.new_empty((B, C, Hs * Ws)) for _ in range(n_out)]
    ptrs = [o.data_ptr() for o in outs] + [0] * (3 - n_out)
    _LAUNCH[name](F.data_ptr(), v0.data_ptr(), dv.data_ptr(), u0.data_ptr(), du.data_ptr(),
                  *ptrs, B, H, W, C, Hs, Ws, *_TILING[name](C),
                  loader.raw_stream(F.get_device()))
    return outs


def gather_tiles_cuda(F, v0, dv, u0, du):
    """Launch K4; every tensor must lie on the same card."""
    return _launch("gather_tiles", 1, F, v0, dv, u0, du)[0]


def gather_tiles_grads_cuda(F, v0, dv, u0, du):
    """Launch K5; every tensor must lie on the same card."""
    return tuple(_launch("gather_tiles_grads", 3, F, v0, dv, u0, du))


def gather_tiles(F, v0, dv, u0, du):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if F.is_cuda:
        return gather_tiles_cuda(F, v0, dv, u0, du)
    check_args(F, v0, dv, u0, du)
    return gather_tiles_ref(F, v0, dv, u0, du)


def gather_tiles_grads(F, v0, dv, u0, du):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if F.is_cuda:
        return gather_tiles_grads_cuda(F, v0, dv, u0, du)
    check_args(F, v0, dv, u0, du)
    return gather_tiles_grads_ref(F, v0, dv, u0, du)


def _tile_boxes(v0, u0, H: int, W: int, th: int):
    """Per ``th x TILE_W`` tile of the corner starts [B,Hs,Ws], clamped to
    [0, size-2]: (vmin, vmax, umin, umax), each [B, tiles down, tiles
    across]."""
    B, Hs, Ws = v0.shape
    Ht, Wt = -(-Hs // th), -(-Ws // TILE_W)
    # repeat the last row and column into the ragged tiles: their extent is
    # that of the live samples
    rows = torch.arange(Ht * th, device=v0.device).clamp(max=Hs - 1)
    cols = torch.arange(Wt * TILE_W, device=v0.device).clamp(max=Ws - 1)

    def tiled(m, hi):
        return m.long().clamp(0, hi)[:, rows][:, :, cols].reshape(B, Ht, th, Wt, TILE_W)

    v, u = tiled(v0, H - 2), tiled(u0, W - 2)
    return v.amin(dim=(2, 4)), v.amax(dim=(2, 4)), u.amin(dim=(2, 4)), u.amax(dim=(2, 4))


def staged_share(v0, u0, H: int, W: int, C: int) -> float:
    """Share of K4's tiles that stage their corner box in shared memory for
    these corner starts [B,Hs,Ws] of a plane [B,H,W,C], as the kernel
    decides it: where the plane :func:`has_window`, per ``tile_rows(C) x
    TILE_W`` tile, the clamped starts' box of ``vmax - vmin + 2`` rows must
    lie in the window's ``tile_rows(C) + 3``, and its last float,
    ``(umax + 2) * C`` into a row, in the ``window_chunks(C)`` chunks from
    the chunk that holds its first, ``umin * C``.  (The kernel stages only
    from a 16-byte aligned plane, as PyTorch allocates them.)"""
    th = tile_rows(C)
    vlo, vhi, ulo, uhi = _tile_boxes(v0, u0, H, W, th)
    c0 = ulo * C // 32 * 32
    staged = (vhi - vlo + 2 <= th + 3) & ((uhi + 2) * C - c0 <= 32 * window_chunks(C))
    return _share(staged) if has_window(W, C) else 0.0


def grads_staged_share(v0, u0, H: int, W: int, C: int) -> float:
    """Share of K5's tiles that stage, as the kernel decides it: per
    ``GRADS_TILE_H x TILE_W`` tile, the clamped starts' box
    ``(vmax - vmin + 2) x (umax - umin + 2) x C`` floats against
    ``GRADS_BOX_FLOATS``."""
    vlo, vhi, ulo, uhi = _tile_boxes(v0, u0, H, W, GRADS_TILE_H)
    box = (vhi - vlo + 2) * (uhi - ulo + 2) * C
    return _share(box <= GRADS_BOX_FLOATS)


def _share(mask) -> float:
    """The share of True in ``mask``, exact: a count over a count (a mean
    on the card multiplies by 1/N, and all-True then reads 1 - 2^-53)."""
    return mask.sum().item() / mask.numel()
