"""PNG decoding and encoding on ``zlib`` and numpy alone.

The machine that runs the card has neither OpenCV nor PIL, so the port
reads the datasets' PNG files and writes its diagnostic images itself.
:func:`read_png` returns the samples of a non-interlaced file of colour
type 0 (gray), 2 (RGB), 4 (gray and alpha) or 6 (RGBA) at 8 or 16 bits, in
the file's channel order, with 16-bit samples as ``uint16``; of an 8-bit
palette file (colour type 3) it returns the palette indices, one channel,
as PIL reads them.  Bit depths under 8 and interlaced files raise
``ValueError`` with the file's name.  :func:`write_png` writes 8-bit RGB.

Each row of the file is filtered by one of five filters.  Python's
``zlib`` inflates the data; the rows are rebuilt by the native host tier
(:mod:`.native_io`, one C++ pass) unless ``plain=True`` asks for the numpy
twin, which gives the same bytes.  There None, Sub (a running sum mod 256
along the row) and Up (a sum with the row above) take a few numpy
operations a row.  Average and Paeth depend on the reconstructed byte to
the left, so an image with any such row is rebuilt along its
anti-diagonals instead: every byte depends only on its left, upper and
upper-left neighbours, so one step rebuilds every pixel of one diagonal,
``H + W - 1`` steps in all.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native_io

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body, crc = data[pos + 8:pos + 8 + length], data[pos + 8 + length:pos + 12 + length]
        if len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def read_png(path: str, plain: bool = False) -> np.ndarray:
    """Decode a PNG file into ``[H, W, channels]`` samples (``uint8``, or
    ``uint16`` at 16 bits); ``plain`` rebuilds the rows in numpy instead of
    the native tier."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or (color == 3 and depth != 8):
        raise ValueError(f"{path}: PNG colour type {color} at {depth} bits is not supported "
                         "(bit depths under 8 are not)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8  # bytes per pixel: the filters' left distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"{path}: PNG image data has {raw.size} bytes, expected "
                         f"{height * (width * bpp + 1)}")
    raw = raw.reshape(height, width * bpp + 1)
    filters = raw[:, 0]
    if (filters > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    if not plain:
        return native_io.png_unfilter(raw, height, width, channels, depth)
    rows = raw[:, 1:].reshape(height, width, bpp)
    if (filters >= 3).any():
        pixels = _unfilter_diagonals(rows, filters)
    else:
        pixels = _unfilter_rows(rows, filters)
    if depth == 16:
        return pixels.reshape(height, width * channels * 2).view(">u2").astype(
            np.uint16).reshape(height, width, channels)
    return pixels.reshape(height, width, channels)


def _unfilter_rows(rows: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Rebuild rows filtered by None (0), Sub (1) or Up (2)."""
    out = np.empty_like(rows)
    prev = np.zeros_like(rows[0])
    for y, f in enumerate(filters):
        if f == 1:
            prev = np.cumsum(rows[y], axis=0, dtype=np.uint8)
        elif f == 2:
            prev = rows[y] + prev
        else:
            prev = rows[y]
        out[y] = prev
    return out


def _unfilter_diagonals(rows: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Rebuild rows filtered by any of the five filters, one anti-diagonal
    of pixels a step (the Average and Paeth filters need the rebuilt pixel
    to the left)."""
    H, W, _ = rows.shape
    # a zero row above and a zero column left of the image
    out = np.zeros((H + 1, W + 1, rows.shape[2]), np.int16)
    coded = rows.astype(np.int16)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(d, H - 1) + 1)
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(filters[y][:, None], (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        out[y + 1, x + 1] = (coded[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img``, ``uint8`` [H,W,3], as a non-interlaced 8-bit RGB PNG
    (colour type 2) with unfiltered rows."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: write_png takes uint8 [H,W,3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
