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
(``csrc/gather_tiles.cu``) give each CTA one ``TILE_H x TILE_W`` tile of
the sample grid: it stages its samples' corner box of the plane in
``BOX_FLOATS`` floats of shared memory when the box fits, and reads the
corners from device memory when it does not.  ``gather_tiles`` and
``gather_tiles_grads`` dispatch on the tensors' device alone: CUDA tensors
launch a kernel, CPU tensors take the plain version.

:func:`use_tiles` is the JAX package's route: the warp takes these kernels
exactly where the JAX package would take its tile kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import loader
from .gather import gather_twohot_ref
from .gather_grads import gather_twohot_grads_ref

TILE_H, TILE_W = 8, 32  # one warp per tile row: coalesced coordinate loads and stores
BOX_FLOATS = 6656  # 26 KB of shared memory per CTA: an SM holds eight such CTAs

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_ARGTYPES_GRADS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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


def _launch(name, argtypes, n_out, F, maps):
    """Check the arguments, allocate ``n_out`` outputs [B,C,Hs*Ws] and
    launch kernel ``name``; returns the outputs."""
    check_args(F, *maps)
    for t in (F, *maps):
        if not t.is_cuda or t.device != F.device:
            raise ValueError(f"{name}_cuda needs CUDA tensors on one device")
    B, H, W, C = F.shape
    _, Hs, Ws = maps[0].shape
    # separate buffers: the training backward keeps gx and gy alive, not out
    outs = tuple(torch.empty((B, C, Hs * Ws), dtype=torch.float32, device=F.device)
                 for _ in range(n_out))
    fn = loader.function(name, f"{name}_launch", argtypes)
    stream = torch.cuda.current_stream(F.device).cuda_stream
    loader.check(fn(F.data_ptr(), *(m.data_ptr() for m in maps), *(o.data_ptr() for o in outs),
                    B, H, W, C, Hs, Ws, TILE_H, BOX_FLOATS, stream), name)
    loader.LAUNCHES[name] += 1
    return outs


def gather_tiles_cuda(F, v0, dv, u0, du):
    """Launch K4; every tensor must lie on the same card."""
    return _launch("gather_tiles", _ARGTYPES, 1, F, (v0, dv, u0, du))[0]


def gather_tiles_grads_cuda(F, v0, dv, u0, du):
    """Launch K5; every tensor must lie on the same card."""
    return _launch("gather_tiles_grads", _ARGTYPES_GRADS, 3, F, (v0, dv, u0, du))


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


def staged_share(v0, u0, H: int, W: int, C: int) -> float:
    """Share of the kernels' CTAs that stage their corner box in shared
    memory for these corner starts [B,Hs,Ws], computed as the kernels decide
    it: per TILE_H x TILE_W tile, the clamped starts' box
    ``(vmax - vmin + 2) x (umax - umin + 2) x C`` floats against BOX_FLOATS."""
    B, Hs, Ws = v0.shape
    Ht, Wt = -(-Hs // TILE_H), -(-Ws // TILE_W)
    # repeat the last row and column into the ragged tiles: their extent is
    # that of the live samples
    rows = torch.arange(Ht * TILE_H, device=v0.device).clamp(max=Hs - 1)
    cols = torch.arange(Wt * TILE_W, device=v0.device).clamp(max=Ws - 1)

    def extent(m, hi):
        m = m.clamp(0, hi)[:, rows][:, :, cols].reshape(B, Ht, TILE_H, Wt, TILE_W)
        return m.amax(dim=(2, 4)) - m.amin(dim=(2, 4)) + 2

    box = extent(v0.long(), H - 2) * extent(u0.long(), W - 2) * C
    return (box <= BOX_FLOATS).double().mean().item()
