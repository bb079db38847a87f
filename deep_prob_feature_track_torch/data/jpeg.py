"""A baseline JPEG decoder on numpy and the standard library alone.

It decodes what ``cv2.imread(path, cv2.IMREAD_COLOR)`` decodes, to the
same bits as the libjpeg-turbo that OpenCV bundles: the JAX package reads
ScanNet's ``frame-XXXXXX.color.jpg`` frames through OpenCV, which the
card's machine lacks.  The bits are decided by four steps, each copied
here in integer arithmetic:

- the inverse DCT is libjpeg's ``jpeg_idct_islow`` (``jidctint.c``: 13-bit
  constants, two passes, the post-IDCT range-limit table);
- chroma is upsampled by libjpeg-turbo's "fancy" triangle filter
  (``jdsample.c``: ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample``,
  ``h2v2_fancy_upsample``, with their alternating rounding biases, the
  edge columns and the replicated first and last rows), not the merged
  upsampler nor IJG v7+'s DCT scaling; a component at most 2 samples
  wide is replicated instead, as there;
- YCbCr becomes RGB through ``jdcolor.c``'s fixed-point ``ycc_rgb_convert``
  (``SCALEBITS`` 16);
- the padding of partial MCUs is cropped.

Supported: baseline and extended sequential 8-bit Huffman files (SOF0,
SOF1), 8- and 16-bit quantization tables, any Huffman tables (optimised
ones too), restart intervals, byte stuffing and fill bytes, one component
(gray, expanded to three equal channels as OpenCV expands it) or three
YCbCr components at h1v1, h2v1, h1v2 or h2v2 chroma sampling.
Progressive, arithmetic-coded, 12-bit, lossless and hierarchical files,
CMYK and RGB (Adobe transform 0, or components named R, G, B) raise
``ValueError`` naming the file.

Python parses the markers and tables and raises every ``ValueError``;
the scans' entropy-coded data, the inverse DCT, the upsampling and the
colour conversion run in the native host tier (:mod:`.native_io`, C++)
unless ``plain=True`` asks for the numpy twin, which gives the same bits.
The twin's Huffman decode is a Python loop over the symbols: 0.1-0.2 s
for a 640x480 frame (``PERF.md`` has the times on the card's host).
"""

from __future__ import annotations

import struct
from array import array
from typing import Dict, List, Tuple

import numpy as np

from . import native_io

# zigzag position -> natural (row-major) position; 16 extra entries absorb
# a corrupt run past the end, as libjpeg's jpeg_natural_order does
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

_UNSUPPORTED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
    0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
    0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
    0xCF: "arithmetic-coded",
}


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.coefs = None  # array('i'), 64 per block, rows of blocks_w blocks
        self.blocks_w = self.blocks_h = 0


def _huffman_lut(counts: List[int], symbols: bytes, path: str) -> List[int]:
    """A 65536-entry table from a 16-bit peek to ``length << 8 | symbol``
    (0 where no code starts with those bits)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols) or code >= (1 << length):
                raise ValueError(f"{path}: bad Huffman table")
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = length << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _check_huffman(counts: List[int], symbols: bytes, path: str) -> bytes:
    """The DHT table ``counts`` + ``symbols`` as the native tier takes it,
    after the checks of :func:`_huffman_lut`."""
    code = k = 0
    for length in range(1, 17):
        code, k = code + counts[length - 1], k + counts[length - 1]
        if k > len(symbols) or code > (1 << length):
            raise ValueError(f"{path}: bad Huffman table")
        code <<= 1
    return bytes(counts) + symbols[:k]


def _windows(data: bytes) -> List[int]:
    """For every bit position p of ``data``, the 32 bits from p on (zeros
    past the end, as libjpeg feeds zeros once the data runs out)."""
    b = np.frombuffer(data + b"\0" * 8, np.uint8).astype(np.int64)
    n = len(data) + 1
    u40 = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    w = (u40[:, None] >> (8 - np.arange(8))[None, :]) & 0xFFFFFFFF
    return w.reshape(-1).tolist()


def _decode_segment(data: bytes, jobs, dc_luts, ac_luts, coefs, path: str) -> None:
    """Huffman-decode the blocks ``jobs`` (``(component, first coefficient
    index)`` in stream order) of one restart interval's unstuffed bytes
    into the coefficient arrays, natural order, DC predictors from 0."""
    try:
        _decode_blocks(_windows(data), jobs, dc_luts, ac_luts, coefs, path)
    except IndexError:
        raise ValueError(f"{path}: JPEG data ends inside a block") from None


def _decode_blocks(win, jobs, dc_luts, ac_luts, coefs, path: str) -> None:
    zz = ZIGZAG
    pred = [0] * len(coefs)
    pos = 0
    for ci, base in jobs:
        out = coefs[ci]
        act = ac_luts[ci]
        e = dc_luts[ci][win[pos] >> 16]
        if not e:
            raise ValueError(f"{path}: corrupt Huffman data")
        pos += e >> 8
        s = e & 255
        if s:
            v = win[pos] >> (32 - s)
            pos += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred[ci] += v
        out[base] = pred[ci]
        k = 1
        while k < 64:
            e = act[win[pos] >> 16]
            if not e:
                raise ValueError(f"{path}: corrupt Huffman data")
            pos += e >> 8
            s = e & 15
            if s:
                k += (e >> 4) & 15
                v = win[pos] >> (32 - s)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                out[base + zz[k]] = v
                k += 1
            elif (e >> 4) & 15 == 15:
                k += 16
            else:
                break


def _entropy_segments(buf: bytes, start: int) -> Tuple[List[bytes], int]:
    """The unstuffed entropy-coded bytes from ``start``, split at the
    restart markers, and the offset of the marker that ends them."""
    segments, pieces = [], []
    i, n = start, len(buf)
    while True:
        j = buf.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            pieces.append(buf[i:])
            segments.append(b"".join(pieces))
            return segments, n
        pieces.append(buf[i:j])
        k = j + 1
        while k < n and buf[k] == 0xFF:  # fill bytes
            k += 1
        if k >= n:
            segments.append(b"".join(pieces))
            return segments, n
        m = buf[k]
        if m == 0x00:  # a stuffed 0xFF data byte
            pieces.append(b"\xff")
            i = k + 1
        elif 0xD0 <= m <= 0xD7:  # RSTn: a new interval
            segments.append(b"".join(pieces))
            pieces = []
            i = k + 1
        else:
            segments.append(b"".join(pieces))
            return segments, k - 1


def _idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` of [N,64] natural-order coefficients with the
    natural-order quantization table: [N,8,8] uint8 samples."""
    CONST_BITS, PASS1_BITS = 13, 2
    F = {k: v for k, v in (
        ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
        ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
        ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
        ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_d(x, shift):
        """The 1-D pass along axis 1 of x [N,8,8]: ``x[:, k]`` is input k."""
        z2, z3 = x[:, 2], x[:, 6]
        z1 = (z2 + z3) * F["0_541196100"]
        tmp2 = z1 + z3 * -F["1_847759065"]
        tmp3 = z1 + z2 * F["0_765366865"]
        tmp0 = (x[:, 0] + x[:, 4]) << CONST_BITS
        tmp1 = (x[:, 0] - x[:, 4]) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * F["1_175875602"]
        t0 = t0 * F["0_298631336"]
        t1 = t1 * F["2_053119869"]
        t2 = t2 * F["3_072711026"]
        t3 = t3 * F["1_501321110"]
        z1 = z1 * -F["0_899976223"]
        z2 = z2 * -F["2_562915447"]
        z3 = z3 * -F["1_961570560"] + z5
        z4 = z4 * -F["0_390180644"] + z5
        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4
        out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        return np.stack([descale(o, shift) for o in out], axis=1)

    x = coefs.astype(np.int64).reshape(-1, 8, 8) * quant.astype(np.int64).reshape(1, 8, 8)
    ws = one_d(x, CONST_BITS - PASS1_BITS)  # columns: ws[n, out_row, col]
    rows = one_d(ws.transpose(0, 2, 1), CONST_BITS + PASS1_BITS + 3)  # [n, out_col, row]
    return _RANGE_LIMIT[rows.transpose(0, 2, 1) & 1023]


def _post_idct_table() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table, indexed by ``x & 1023``."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _post_idct_table()


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample`` along the last axis of a uint8 plane."""
    a = x.astype(np.int32)
    prev = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
    nxt = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    out = np.empty(a.shape[:1] + (2 * a.shape[1],), np.uint8)
    out[:, 0::2] = (3 * a + prev + 1) >> 2
    out[:, 1::2] = (3 * a + nxt + 2) >> 2
    return out


def _fancy_v2(x: np.ndarray) -> np.ndarray:
    """``h1v2_fancy_upsample`` along the first axis of a uint8 plane."""
    a = x.astype(np.int32)
    above = np.concatenate([a[:1], a[:-1]], axis=0)
    below = np.concatenate([a[1:], a[-1:]], axis=0)
    out = np.empty((2 * a.shape[0],) + a.shape[1:], np.uint8)
    out[0::2] = (3 * a + above + 1) >> 2
    out[1::2] = (3 * a + below + 2) >> 2
    return out


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample`` of a uint8 plane: vertical 3:1 column sums,
    then a horizontal 3:1 blend with biases 8 and 7."""
    a = x.astype(np.int32)
    above = np.concatenate([a[:1], a[:-1]], axis=0)
    below = np.concatenate([a[1:], a[-1:]], axis=0)
    out = np.empty((2 * a.shape[0], 2 * a.shape[1]), np.uint8)
    for v, far in ((0, above), (1, below)):
        col = 3 * a + far
        prev = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * col + prev + 8) >> 4
        out[v::2, 1::2] = (3 * col + nxt + 7) >> 4
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int, path: str) -> np.ndarray:
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (1, 2):
        return _fancy_v2(plane)
    if fh == 2 and fv in (1, 2) and plane.shape[1] <= 2:
        # too narrow for the fancy filter: plain replication
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    if (fh, fv) == (2, 1):
        return _fancy_h2(plane)
    if (fh, fv) == (2, 2):
        return _fancy_h2v2(plane)
    raise ValueError(f"{path}: unsupported chroma sampling factors {fh}x{fv}")


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert`` (SCALEBITS 16)."""
    SCALEBITS, ONE_HALF = 16, 1 << 15
    x_cb = cb.astype(np.int64) - 128
    x_cr = cr.astype(np.int64) - 128
    cr_r = (91881 * x_cr + ONE_HALF) >> SCALEBITS
    cb_b = (116130 * x_cb + ONE_HALF) >> SCALEBITS
    g = (-46802 * x_cr + (-22554 * x_cb + ONE_HALF)) >> SCALEBITS
    y = y.astype(np.int64)
    return np.clip(np.stack([y + cr_r, y + g, y + cb_b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(buf: bytes, path: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """Decode a baseline JPEG into uint8 RGB [H,W,3] (gray repeated into
    three channels), as ``cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]``;
    ``plain`` decodes in Python and numpy instead of the native tier.

    :raises ValueError: naming ``path``, on an unsupported or corrupt file
    """
    if buf[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    quant: Dict[int, np.ndarray] = {}
    dc_luts: Dict[int, List[int]] = {}
    ac_luts: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    restart = 0
    adobe_transform = None
    jfif = False
    X = Y = 0
    hmax = vmax = 1
    pos = 2
    n = len(buf)
    while pos < n:
        if buf[pos] != 0xFF:
            raise ValueError(f"{path}: expected a marker at byte {pos}")
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = buf[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        (length,) = struct.unpack(">H", buf[pos:pos + 2])
        seg = buf[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED:
            raise ValueError(f"{path}: {_UNSUPPORTED[marker]} JPEG is not supported")
        if marker in (0xC0, 0xC1):
            precision, Y, X, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG is not supported")
            if nf not in (1, 3):
                raise ValueError(f"{path}: JPEG with {nf} components (CMYK?) is not supported")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                seg[8 + 3 * i]) for i in range(nf)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-X // (8 * hmax))
            mcuy = -(-Y // (8 * vmax))
            for c in comps:
                c.blocks_w, c.blocks_h = mcux * c.h, mcuy * c.v
                c.coefs = array("i", bytes(4 * 64 * c.blocks_w * c.blocks_h))
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(seg[i + 1:i + 65])
                    i += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG[:64]] = vals
                quant[tq] = table
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                total = sum(counts)
                table = seg[i + 17:i + 17 + total]
                (ac_luts if tc else dc_luts)[th] = (
                    _huffman_lut(counts, table, path) if plain
                    else _check_huffman(counts, table, path))
                i += 17 + total
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:
            if not comps:
                raise ValueError(f"{path}: scan before the frame header")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next(k for k, c in enumerate(comps) if c.cid == cid)
                scan.append((ci, tables >> 4, tables & 15))
            if plain:
                segments, pos = _entropy_segments(buf, pos)
                _decode_scan(comps, scan, X, Y, hmax, vmax, restart, segments,
                             dc_luts, ac_luts, path)
            else:
                pos = _native_scan(buf, pos, comps, scan, X, Y, hmax, vmax, restart,
                                   dc_luts, ac_luts, path)
    if not comps:
        raise ValueError(f"{path}: no frame header")
    if len(comps) == 3:
        ids = tuple(c.cid for c in comps)
        if (not jfif and adobe_transform == 0) or (
                not jfif and adobe_transform is None and ids == (82, 71, 66)):
            raise ValueError(f"{path}: RGB-coded JPEG is not supported")
    if not plain:
        return _native_pixels(comps, quant, X, Y, hmax, vmax, path)
    planes = []
    for c in comps:
        if c.tq not in quant:
            raise ValueError(f"{path}: missing quantization table {c.tq}")
        coefs = np.frombuffer(c.coefs, np.int32).reshape(-1, 64)
        blocks = _idct_islow(coefs, quant[c.tq])
        plane = blocks.reshape(c.blocks_h, c.blocks_w, 8, 8).transpose(0, 2, 1, 3).reshape(
            8 * c.blocks_h, 8 * c.blocks_w)
        w = -(-X * c.h // hmax)
        h = -(-Y * c.v // vmax)
        plane = _upsample(plane[:h, :w], hmax // c.h, vmax // c.v, path)
        planes.append(plane[:Y, :X])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return _ycc_to_rgb(*planes)


def _decode_scan(comps, scan, X, Y, hmax, vmax, restart, segments, dc_luts, ac_luts, path):
    """Decode one sequential scan's blocks into its components."""
    if len(scan) == 1:  # non-interleaved: one block an MCU, the component's own grid
        ci = scan[0][0]
        c = comps[ci]
        bw = -(-(-(-X * c.h // hmax)) // 8)
        bh = -(-(-(-Y * c.v // vmax)) // 8)
        jobs = [(ci, 64 * (r * c.blocks_w + col)) for r in range(bh) for col in range(bw)]
        per_mcu = 1
    else:
        mcux = -(-X // (8 * hmax))
        mcuy = -(-Y // (8 * vmax))
        jobs = []
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, _, _ in scan:
                    c = comps[ci]
                    for by in range(c.v):
                        for bx in range(c.h):
                            row, col = my * c.v + by, mx * c.h + bx
                            jobs.append((ci, 64 * (row * c.blocks_w + col)))
        per_mcu = sum(comps[ci].h * comps[ci].v for ci, _, _ in scan)
    n_comp = len(comps)
    dcl, acl = [None] * n_comp, [None] * n_comp
    for ci, td, ta in scan:
        if td not in dc_luts or ta not in ac_luts:
            raise ValueError(f"{path}: missing Huffman table")
        dcl[ci], acl[ci] = dc_luts[td], ac_luts[ta]
    coefs = [c.coefs for c in comps]
    step = restart * per_mcu if restart else len(jobs)
    for s, start in enumerate(range(0, len(jobs), step)):
        data = segments[s] if s < len(segments) else b""
        _decode_segment(data, jobs[start:start + step], dcl, acl, coefs, path)


def _native_scan(buf, start, comps, scan, X, Y, hmax, vmax, restart, dc_tables, ac_tables,
                 path) -> int:
    """:func:`_entropy_segments` and :func:`_decode_scan` in the native
    tier; returns the offset of the marker after the scan."""
    for _, td, ta in scan:
        if td not in dc_tables or ta not in ac_tables:
            raise ValueError(f"{path}: missing Huffman table")
    status, end = native_io.jpeg_scan(buf, start, scan, comps, dc_tables, ac_tables, X, Y, hmax,
                                      vmax, restart)
    if status == native_io.TRUNCATED:
        raise ValueError(f"{path}: JPEG data ends inside a block")
    if status:
        raise ValueError(f"{path}: corrupt Huffman data")
    return end


def _native_pixels(comps, quant, X, Y, hmax, vmax, path) -> np.ndarray:
    """:func:`decode_jpeg`'s inverse DCT, upsampling and colour conversion
    in the native tier, after the same checks."""
    for c in comps:
        if c.tq not in quant:
            raise ValueError(f"{path}: missing quantization table {c.tq}")
        fh, fv = hmax // c.h, vmax // c.v
        if (fh, fv) not in ((1, 1), (1, 2), (2, 1), (2, 2)):
            raise ValueError(f"{path}: unsupported chroma sampling factors {fh}x{fv}")
    status, rgb = native_io.jpeg_pixels(comps, quant, X, Y, hmax, vmax)
    if status:
        raise ValueError(f"{path}: unsupported chroma sampling factors")
    return rgb


def read_jpeg(path: str, plain: bool = False) -> np.ndarray:
    """Read a JPEG file into uint8 RGB [H,W,3] (see :func:`decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, plain)
