"""The port's native host tier: ``csrc/host_io.cpp`` bound with ctypes.

Counterpart of ``deep_prob_feature_track_tpu/data/native_io.py``.  The
C++ holds the arithmetic of the decoders that :mod:`.png`, :mod:`.io` and
:mod:`.jpeg` run in numpy, in the same integer and float32 order, so that
both give the same bits: PNG unfiltering, ``read_rgb``'s and
``read_depth_png``'s resizes, ``resize_linear_cv`` and the JPEG scan
decode, inverse DCT, upsampling and colour conversion.  Those modules call
it by default; ``plain=True`` takes their numpy code.  Python keeps the
file parsing (PNG chunks and CRCs, JPEG markers and tables) and raises
every ``ValueError`` naming the file.

The library is compiled by the host's C++ compiler (``$CXX``, else
``c++``) into ``_build/`` beside this module at the first call, never at
import (``ops/kernels/loader.py::build_host``: hash-named, built under a
file lock), and bound with ``ctypes.CDLL``, which releases the GIL for the
length of each call: a decode on the loader's prefetch thread leaves the
interpreter to the training or evaluation loop.  The C++ never calls back
into Python.  A missing compiler or a failed build raises with the
compiler's output; there is no fallback and no switch to turn the tier
off (the JAX package's ``DPFT_NO_NATIVE`` has no counterpart).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

TRUNCATED = 1  # host_io.cpp's status for JPEG data that ends inside a block

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F, _D = ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "hio_png_unfilter": (_P, _I64, _I64, _I64, _I, _P),
    "hio_png_rgb": (_P, _I64, _I64, _I, _I, _I64, _I64, _P),
    "hio_png_depth": (_P, _I64, _I64, _I, _I64, _I64, _F, _I, _F, _F, _P),
    "hio_resize_linear_cv": (_P, _I64, _I64, _I64, _D, _I64, _I64, _P),
    "hio_jpeg_scan": (ctypes.c_char_p, _I64, _I64, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I64,
                      _I64, _I, _I, _I64, _P),
    "hio_jpeg_pixels": (_I, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The host tier's library, built and bound at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops.kernels.loader import build_host

            lib = ctypes.CDLL(str(build_host(SOURCE, BUILD_DIR)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _lib = lib
        return _lib


def _call(name: str, *args) -> int:
    return getattr(library(), name)(*args)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _pointers(arrays: Sequence) -> ctypes.Array:
    """A C array of the addresses of ``arrays`` (numpy arrays or
    ``array.array``s)."""
    return (ctypes.c_void_p * len(arrays))(
        *[a.buffer_info()[0] if hasattr(a, "buffer_info") else a.ctypes.data for a in arrays])


def _check(a: np.ndarray, dtypes, ndims, what: str) -> np.ndarray:
    if not isinstance(a, np.ndarray) or a.dtype not in dtypes or a.ndim not in ndims:
        raise TypeError(f"{what} takes a {'/'.join(np.dtype(d).name for d in dtypes)} array "
                        f"of {' or '.join(map(str, ndims))} dimensions, got "
                        f"{getattr(a, 'dtype', type(a))} {getattr(a, 'shape', '')}")
    return np.ascontiguousarray(a)


# ------------------------------------------------------------------- PNG


def png_unfilter(raw, height: int, width: int, channels: int, depth: int) -> np.ndarray:
    """The samples [H, W, channels] (``uint8``, or host-order ``uint16`` at
    16 bits) of the inflated IDAT bytes ``raw``: ``height`` rows of a filter
    byte (0-4, checked by the caller) and ``width * channels * depth / 8``
    bytes."""
    raw = np.frombuffer(raw, np.uint8)
    bpp = channels * depth // 8
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"png_unfilter: {raw.size} bytes for {height} rows of {width * bpp + 1}")
    out = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    if _call("hio_png_unfilter", _ptr(raw), height, width, bpp, int(depth == 16), _ptr(out)):
        raise ValueError("png_unfilter: a row filter over 4")
    return out


def png_rgb(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``data/io.py::read_rgb``'s arithmetic on PNG samples [H, W, C]
    (``uint8`` or ``uint16``, C = 1-4): float32 [out_h, out_w, 3] in [0,
    1]."""
    img = _check(img, (np.uint8, np.uint16), (3,), "png_rgb")
    H, W, C = img.shape
    if not 1 <= C <= 4:
        raise ValueError(f"png_rgb takes 1-4 channels, got {C}")
    out = np.empty((out_h, out_w, 3), np.float32)
    _call("hio_png_rgb", _ptr(img), H, W, C, int(img.dtype == np.uint16), out_h, out_w, _ptr(out))
    return out


def png_depth(img: np.ndarray, out_h: int, out_w: int, depth_scale: float,
              clip: Optional[Tuple[float, float]]) -> np.ndarray:
    """``data/io.py::read_depth_png``'s arithmetic on one-channel samples
    [H, W, 1]: float32 [out_h, out_w] metres."""
    img = _check(img, (np.uint8, np.uint16), (3,), "png_depth")
    H, W, C = img.shape
    if C != 1:
        raise ValueError(f"png_depth takes one channel, got {C}")
    cmin, cmax = clip if clip is not None else (0.0, -1.0)
    out = np.empty((out_h, out_w), np.float32)
    _call("hio_png_depth", _ptr(img), H, W, int(img.dtype == np.uint16), out_h, out_w,
          depth_scale, int(cmax > 0), cmin, cmax, _ptr(out))
    return out


def resize_linear_cv(img: np.ndarray, scale: float, out_h: int, out_w: int) -> np.ndarray:
    """``data/io.py::resize_linear_cv`` of float32 [H, W, C] (or [H, W])
    into [out_h, out_w, C]."""
    img = _check(img, (np.float32,), (2, 3), "resize_linear_cv")
    H, W = img.shape[:2]
    C = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((out_h, out_w) + img.shape[2:], np.float32)
    _call("hio_resize_linear_cv", _ptr(img), H, W, C, float(scale), out_h, out_w, _ptr(out))
    return out


# ------------------------------------------------------------------ JPEG


def jpeg_scan(buf: bytes, start: int, scan, comps, dc_tables, ac_tables, X: int, Y: int,
              hmax: int, vmax: int, restart: int) -> Tuple[int, int]:
    """Decode one sequential scan of the JPEG file ``buf`` whose
    entropy-coded data starts at ``start`` into its components'
    coefficient arrays (``comps[ci].coefs``, ``array('i')``).  ``scan``
    lists ``(component index, DC table, AC table)``, the tables each a DHT
    table's bytes (16 counts, then the symbols).  Returns the C status (0,
    ``TRUNCATED``, or 2 for a code no table holds) and the offset of the
    marker that ends the scan."""
    ci = np.array([c for c, _, _ in scan], np.int32)
    dc = [dc_tables[td] for _, td, _ in scan]
    ac = [ac_tables[ta] for _, _, ta in scan]
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    bw = np.array([c.blocks_w for c in comps], np.int64)
    end = ctypes.c_int64(0)
    status = _call("hio_jpeg_scan", buf, len(buf), start, len(scan), _ptr(ci),
                   (ctypes.c_char_p * len(dc))(*dc), (ctypes.c_char_p * len(ac))(*ac),
                   len(comps), _ptr(h), _ptr(v), _ptr(bw), _pointers([c.coefs for c in comps]),
                   X, Y, hmax, vmax, restart, ctypes.byref(end))
    return status, end.value


def jpeg_pixels(comps, quant, X: int, Y: int, hmax: int, vmax: int) -> Tuple[int, np.ndarray]:
    """The uint8 RGB [Y, X, 3] of the decoded coefficients of ``comps`` (one
    component: gray in all three channels), ``quant[c.tq]`` each one's
    natural-order table.  Returns the C status (0, or 3 for sampling
    factors it does not take) and the image."""
    tables = [np.ascontiguousarray(quant[c.tq], np.int32) for c in comps]
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    bw = np.array([c.blocks_w for c in comps], np.int64)
    out = np.empty((Y, X, 3), np.uint8)
    status = _call("hio_jpeg_pixels", len(comps), _pointers([c.coefs for c in comps]),
                   _pointers(tables), _ptr(h), _ptr(v), _ptr(bw), X, Y, hmax, vmax, _ptr(out))
    return status, out
