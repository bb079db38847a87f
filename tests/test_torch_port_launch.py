"""The kernels' launch path on the CPU: argument checks, the packed launch
arguments, and K3's binning.

No card and no JAX here.  The ``*_cuda`` wrappers check their arguments with
one fast predicate and, when it fails, raise what the full checks say: the
same ``TypeError`` / ``ValueError`` messages as the dispatching entries,
then the device error.  Each C launch function takes one pointer to a
struct that ``loader.launcher`` packs with a ``struct`` format; the format
must give the C struct's layout.  ``splat.splat_bins`` must bin the samples
exactly as a count of each sample's four corner cells does, and the
scratch of ``splat.scratch_layout`` must hold what the kernel writes.
"""

import ctypes
import re
import struct

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.ops import kernels as tk
from deep_prob_feature_track_torch.ops.kernels import loader, splat

torch.set_num_threads(2)

B, H, W, C, N = 2, 6, 7, 3, 11


def _gather_args(maps_shape=(B, N)):
    g = torch.Generator().manual_seed(0)
    F = torch.randn(B, H, W, C, generator=g)
    v0 = torch.randint(0, H - 1, maps_shape, generator=g, dtype=torch.int32)
    u0 = torch.randint(0, W - 1, maps_shape, generator=g, dtype=torch.int32)
    dv = torch.rand(maps_shape, generator=g)
    du = torch.rand(maps_shape, generator=g)
    return [F, v0, dv, u0, du]


def _non_contiguous(t):
    return t.transpose(0, 1).contiguous().transpose(0, 1) if t.shape[0] != t.shape[1] else t.t()


# (name of a bad argument, how to make it bad, exception, message)
GATHER_FAULTS = [
    ("v0", lambda t: t.long(), TypeError, "v0 must be torch.int32, got torch.int64"),
    ("F", lambda t: t.double(), TypeError, "F must be torch.float32, got torch.float64"),
    ("du", lambda t: t.half(), TypeError, "du must be torch.float32, got torch.float16"),
    ("dv", lambda t: t[:, :-1].contiguous(), ValueError, r"dv must be \[2,11\], got \(2, 10\)"),
    ("F", lambda t: t[:, :1].contiguous(), ValueError, "plane 1x7 is smaller than one 2x2 cell"),
    ("F", lambda t: t[0], ValueError, r"F must be \[B,H,W,C\], got \(6, 7, 3\)"),
    ("du", _non_contiguous, ValueError, "du must be contiguous"),
    ("F", lambda t: t.transpose(1, 2), ValueError, "F must be contiguous"),
]
ARG_NAMES = ("F", "v0", "dv", "u0", "du")


@pytest.mark.parametrize("fault", GATHER_FAULTS, ids=lambda f: f[3][:24])
@pytest.mark.parametrize("cuda_fn,entry", [
    (tk.gather_twohot_cuda, tk.gather_twohot),
    (tk.gather_twohot_grads_cuda, tk.gather_twohot_grads),
])
def test_gather_wrappers_raise_the_checks_errors(cuda_fn, entry, fault):
    name, bad, exc, msg = fault
    args = _gather_args()
    args[ARG_NAMES.index(name)] = bad(args[ARG_NAMES.index(name)])
    for fn in (cuda_fn, entry):
        with pytest.raises(exc, match=msg):
            fn(*args)


@pytest.mark.parametrize("fault", GATHER_FAULTS[:3] + GATHER_FAULTS[4:], ids=lambda f: f[3][:24])
@pytest.mark.parametrize("cuda_fn,entry", [
    (tk.gather_tiles_cuda, tk.gather_tiles),
    (tk.gather_tiles_grads_cuda, tk.gather_tiles_grads),
])
def test_tiles_wrappers_raise_the_checks_errors(cuda_fn, entry, fault):
    name, bad, exc, msg = fault
    args = _gather_args((B, 3, 4))
    args[ARG_NAMES.index(name)] = bad(args[ARG_NAMES.index(name)])
    for fn in (cuda_fn, entry):
        with pytest.raises(exc, match=msg):
            fn(*args)


def test_tiles_wrappers_raise_on_a_wrong_map_shape():
    args = _gather_args((B, 3, 4))
    args[2] = args[2][:, :, :-1].contiguous()
    for fn in (tk.gather_tiles_cuda, tk.gather_tiles_grads):
        with pytest.raises(ValueError, match=r"dv must be \[2, 3, 4\], got \(2, 3, 3\)"):
            fn(*args)


@pytest.mark.parametrize("fn,maps", [
    (tk.gather_twohot_cuda, (B, N)), (tk.gather_twohot_grads_cuda, (B, N)),
    (tk.gather_tiles_cuda, (B, 3, 4)), (tk.gather_tiles_grads_cuda, (B, 3, 4)),
])
def test_gather_wrappers_refuse_cpu_tensors(fn, maps):
    with pytest.raises(ValueError, match=f"{fn.__name__} needs CUDA tensors on one device"):
        fn(*_gather_args(maps))


def _splat_args():
    F, v0, dv, u0, du = _gather_args()
    g = torch.randn(B, C, N, generator=torch.Generator().manual_seed(1))
    return [g, v0, dv, u0, du]


SPLAT_FAULTS = [
    (0, lambda t: t.double(), TypeError, "g must be torch.float32, got torch.float64"),
    (3, lambda t: t.long(), TypeError, "u0 must be torch.int32, got torch.int64"),
    (1, lambda t: t[:1].contiguous(), ValueError, r"v0 must be \[2,11\], got \(1, 11\)"),
    (0, lambda t: t[0], ValueError, r"g must be \[B,C,N\], got \(3, 11\)"),
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), ValueError,
     "g must be contiguous"),
    (4, _non_contiguous, ValueError, "du must be contiguous"),
]


@pytest.mark.parametrize("fault", SPLAT_FAULTS, ids=lambda f: f[3][:24])
def test_splat_wrappers_raise_the_checks_errors(fault):
    i, bad, exc, msg = fault
    args = _splat_args()
    args[i] = bad(args[i])
    for fn in (tk.splat_twohot_cuda, tk.splat_twohot):
        with pytest.raises(exc, match=msg):
            fn(*args, H, W)


def test_splat_wrappers_raise_on_a_small_plane_and_cpu_tensors():
    for fn in (tk.splat_twohot_cuda, tk.splat_twohot):
        with pytest.raises(ValueError, match="plane 1x7 is smaller than one 2x2 cell"):
            fn(*_splat_args(), 1, W)
    with pytest.raises(ValueError, match="splat_twohot_cuda needs CUDA tensors on one device"):
        tk.splat_twohot_cuda(*_splat_args(), H, W)


def _jtj_args(hw=10):
    g = torch.Generator().manual_seed(2)
    return [torch.randn(*s, generator=g) for s in ((B, 4, hw),) * 3 + ((B, hw, 6),) * 2]


JTJ_FAULTS = [
    (1, lambda t: t.double(), TypeError, "beta must be float32, got torch.float64"),
    (4, lambda t: t[:, :-1].contiguous(), ValueError, r"v must be \(2, 10, 6\), got \(2, 9, 6\)"),
    (0, lambda t: t[0], ValueError, r"alpha must be \[B,C,HW\], got \(4, 10\)"),
    (2, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), ValueError,
     "res must be contiguous"),
]


@pytest.mark.parametrize("fault", JTJ_FAULTS, ids=lambda f: f[3][:24])
def test_jtj_wrappers_raise_the_checks_errors(fault):
    i, bad, exc, msg = fault
    args = _jtj_args()
    args[i] = bad(args[i])
    for fn in (tk.fused_jtj_jtr_cuda, tk.fused_jtj_jtr):
        with pytest.raises(exc, match=msg):
            fn(*args, sign=-1.0)
    with pytest.raises(ValueError, match="fused_jtj_jtr_cuda needs CUDA tensors on one device"):
        tk.fused_jtj_jtr_cuda(*_jtj_args(), sign=-1.0)


# ------------------------------------------------- packed launch arguments

_CTYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const int*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "int64_t*": ctypes.c_void_p, "unsigned*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float}


def _c_structs():
    """Every launch function's argument struct in the CUDA sources:
    {symbol: [(field, ctypes type), ...]}."""
    out = {}
    for src in loader.CSRC.glob("*.cu"):
        text = src.read_text()
        for symbol, name in re.findall(r'extern "C" int (\w+)\(const (\w+)\* a\)', text):
            body = re.search(rf"struct {name} \{{(.*?)\n\}};", text, re.S).group(1)
            fields = []
            for decl in re.sub(r"//[^\n]*", "", body).split(";"):
                m = re.match(r"\s*((?:const )?\w+\*?)\s+(.+)", decl.strip())
                if m:
                    fields += [(f.strip(), _CTYPES[m.group(1)]) for f in m.group(2).split(",")]
            out[symbol] = fields
    return out


def test_every_launch_function_takes_a_struct_the_wrapper_packs():
    structs = _c_structs()
    assert sorted(structs) == sorted(loader.FORMATS) == sorted(
        f"{name}_launch" for name in loader.SOURCES)


@pytest.mark.parametrize("symbol", sorted(f"{name}_launch" for name in loader.SOURCES))
def test_packed_arguments_have_the_c_struct_layout(symbol):
    fields = _c_structs()[symbol]
    cls = type("Args", (ctypes.Structure,), {"_fields_": fields})
    values = [0x7F0000001000 + 64 * i if t is ctypes.c_void_p else
              (0.5 * i if t is ctypes.c_float else 3 * i + 1)
              for i, (_, t) in enumerate(fields)]
    packed = struct.pack(loader.FORMATS[symbol], *values)
    c = bytes(cls(*values))
    # the struct module leaves out the C struct's trailing padding
    assert packed == c[:len(packed)] and len(c) - len(packed) < 8


# ------------------------------------------------------------- K3's bins


def _brute_bins(v0, u0, H, W, C):
    """K3's bins counted one corner at a time: the clamped start's four
    corner cells, the tile of each, each distinct tile of a sample once;
    then the bins over SPLIT entries split, in tile order, while merge
    slots last."""
    B, N = v0.shape
    TY, TX = -(-H // splat.TILE_H), -(-W // splat.TILE_W)
    v = np.clip(v0, 0, H - 2)
    u = np.clip(u0, 0, W - 2)
    tiles = np.stack([(np.arange(B)[:, None] * TY + (v + dy) // splat.TILE_H) * TX
                      + (u + dx) // splat.TILE_W for dy in (0, 1) for dx in (0, 1)], axis=-1)
    tiles = np.sort(tiles, axis=-1)
    first = np.concatenate([np.ones((B, N, 1), bool), tiles[..., 1:] != tiles[..., :-1]], -1)
    counts = np.zeros(B * TY * TX, np.int64)
    np.add.at(counts, tiles[first], 1)
    slots = min(B * TY * TX, splat.SLOTS_PER_IMAGE * B)
    split, parts = np.zeros_like(counts, bool), np.ones_like(counts)
    for t in range(len(counts)):
        if counts[t] > splat.SPLIT and split.sum() < slots:
            split[t] = True
            parts[t] = -(-counts[t] // splat.SPLIT)
    groups = -(-C // splat.MAX_GROUP)
    widths = [len(range(C)[i::groups]) for i in range(groups)]  # as even as they go
    return {"counts": counts.reshape(B, TY, TX), "split": split.reshape(B, TY, TX),
            "parts": parts.reshape(B, TY, TX), "groups": groups, "width": max(widths),
            "ctas": int(parts.sum()) * groups,
            "cross_share": float((first.sum(-1) > 1).mean()),
            "split_share": float(split.mean())}


@pytest.mark.parametrize("C", [1, 10, 17, 40])
@pytest.mark.parametrize("coords", ["random", "smooth", "teleported", "offplane"])
@pytest.mark.parametrize("Hp,Wp,n", [(120, 160, 120 * 160 - 13), (30, 40, 1200), (2, 2, 300),
                                     (45, 50, 45 * 50 - 60)])
def test_splat_staged_share_matches_a_per_tile_count(C, coords, Hp, Wp, n):
    """``splat_bins`` against the corner-by-corner count: every bin's size,
    the split bins and their CTAs, the channel groups, the shares; and the
    work list of ``scratch_layout`` holds every CTA the kernel queues."""
    rng = np.random.RandomState(C)
    if coords == "random":
        v = rng.randint(-3, Hp + 2, (3, n))
        u = rng.randint(-3, Wp + 2, (3, n))
    else:
        y, x = np.divmod(np.arange(n), Wp)
        v = np.broadcast_to(y + np.round(0.8 * np.cos(x / 11.0)), (3, n)).copy()
        u = np.broadcast_to(x + np.round(0.8 * np.sin(y / 9.0)), (3, n)).copy()
        if coords == "offplane":  # spread 4x about the centre: most clamp to the border
            v, u = (v - Hp // 2) * 4 + Hp // 2, (u - Wp // 2) * 4 + Wp // 2
        if coords == "teleported":
            idx = rng.randint(0, n, (3, 5))
            np.put_along_axis(v, idx, (np.take_along_axis(v, idx, 1) + Hp // 2) % Hp, 1)
            np.put_along_axis(u, idx, (np.take_along_axis(u, idx, 1) + Wp // 2) % Wp, 1)
    v0, u0 = (torch.from_numpy(a.astype(np.int32)) for a in (v, u))
    got = splat.splat_bins(v0, u0, Hp, Wp, C)
    ref = _brute_bins(v.astype(np.int64), u.astype(np.int64), Hp, Wp, C)
    for key in ("counts", "split", "parts"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    for key in ("groups", "width", "ctas"):
        assert got[key] == ref[key], key
    for key in ("cross_share", "split_share"):
        assert got[key] == pytest.approx(ref[key], abs=1e-12), key
    lay = splat.scratch_layout(3, Hp, Wp, C, n)
    assert got["ctas"] <= lay["work_cap"] * got["groups"]
    assert ref["counts"].sum() <= 4 * 3 * n and ref["split"].sum() <= lay["slots"]
    if (coords, Hp) == ("offplane", 120):  # the corners' bins spread over CTAs
        assert ref["split"][:, 0, 0].all()
    if coords == "smooth":
        assert not ref["split"].any()


def test_splat_tiling_constants_are_the_kernels():
    """``splat.py``'s model of the kernel's tiling uses the constants that
    ``csrc/splat_twohot.cu`` compiles with."""
    text = (loader.CSRC / "splat_twohot.cu").read_text()
    consts = {name: int(value) for name, value in
              re.findall(r"\b(k[A-Z]\w*) = (\d+)\b", text)}
    assert (consts["kTileH"], consts["kTileW"]) == (splat.TILE_H, splat.TILE_W)
    assert consts["kSplit"] == splat.SPLIT and consts["kMaxGroup"] == splat.MAX_GROUP
    assert consts["kChunk"] < consts["kSplit"]
