"""The port's native host tier (``data/native_io.py``, ``data/csrc/host_io.cpp``)
against the numpy twins it replaces on the main path, bit for bit.

``read_png``, ``read_jpeg``, ``read_rgb``, ``read_depth_png`` and
``resize_linear_cv`` run the C++ by default and the numpy code with
``plain=True``; every case holds the two equal with
``assert_array_equal``, and holds the PNG reads to the JAX package's native
tier (``native/libdpft_io.so``, libpng) and the JPEG reads and
``resize_linear_cv`` to OpenCV, as ``tests/test_torch_port_data.py`` and
``tests/test_torch_port_jpeg.py`` hold the numpy twins.

``resize_linear_cv``'s numpy twin blends in ``longdouble`` and the C++ with
``std::fmaf``: the two agree on every case here, random, 8-bit and nearly
flat float32 images alike, and both agree with OpenCV, so neither was
changed.
At scale 1.0 both differ from ``cv2.resize``, which copies the image,
while the twins blend the last row and column with weight 1 (an ulp off);
``read_rgb`` never resizes at 1.0.

Files are written by ``chip_smoke.write_png`` (one PNG filter a row, any
colour type), PIL (palette PNGs; JPEG at 4:4:4, 4:2:2 and 4:2:0, optimised
Huffman tables, 16-bit quantization tables) and OpenCV and
``chip_smoke.write_jpeg`` (restart intervals, 4:4:0, gray).
"""

import ctypes
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from chip_smoke import write_png
from deep_prob_feature_track_torch.data import io as pio
from deep_prob_feature_track_torch.data import native_io
from deep_prob_feature_track_torch.data.jpeg import decode_jpeg, read_jpeg
from deep_prob_feature_track_torch.data.png import read_png
from deep_prob_feature_track_torch.ops.kernels import loader
from deep_prob_feature_track_tpu.data import io as jio
from deep_prob_feature_track_tpu.data import native_io as jax_native_io

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (1.0, 0.25, 0.1)
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4, "mixed": np.arange(41) % 5}
H, W = 41, 53  # odd sizes: every resize rounds


def _scene(h, w, c, dtype, seed=0):
    """A smooth texture plus noise, so that every filter predicts badly
    somewhere and the blends see every value."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([0.5 + 0.4 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) for k in range(c)], -1)
    img = np.clip(img + rng.randn(h, w, c) * 0.08, 0, 1)
    hi = 65535 if dtype == np.uint16 else 255
    return np.rint(img * hi).astype(dtype)


def _equal(path, **kw):
    got, ref = read_png(path, **kw), read_png(path, plain=True)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


# ------------------------------------------------------------------- PNG


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_png_decodes_as_numpy(tmp_path, filt, channels, depth):
    """Every filter, and one a row, at every colour type and both depths:
    the samples, ``read_rgb`` at every scale and, of one channel,
    ``read_depth_png`` with and without the clip."""
    dtype = np.uint16 if depth == 16 else np.uint8
    img = _scene(H, W, channels, dtype)
    path = str(tmp_path / "x.png")
    write_png(path, img, filter_type=FILTERS[filt])
    np.testing.assert_array_equal(_equal(path), img)
    for scale in SCALES:
        got, ref = pio.read_rgb(path, scale), pio.read_rgb(path, scale, plain=True)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        if channels == 1:
            for clip in ((0.5, 5.0), None):
                got = pio.read_depth_png(path, 5000.0, scale, clip)
                ref = pio.read_depth_png(path, 5000.0, scale, clip, plain=True)
                assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("filt", ["sub", "average", "paeth", "mixed"])
def test_full_size_frames_decode_as_numpy(tmp_path, filt):
    """A 640x480 RGB frame and a 16-bit depth map, as the TUM loader reads
    them."""
    path, depth = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    write_png(path, _scene(480, 640, 3, np.uint8, seed=1),
              filter_type=np.arange(480) % 5 if filt == "mixed" else FILTERS[filt])
    write_png(depth, _scene(480, 640, 1, np.uint16, seed=2)[..., 0] // 6, filter_type=4)
    _equal(path)
    np.testing.assert_array_equal(pio.read_rgb(path, 0.25), pio.read_rgb(path, 0.25, plain=True))
    np.testing.assert_array_equal(pio.read_depth_png(depth, 5000.0, 0.25),
                                  pio.read_depth_png(depth, 5000.0, 0.25, plain=True))


def test_palette_indices_decode_as_numpy_and_pil(tmp_path):
    idx = (_scene(H, W, 1, np.uint8)[..., 0] // 16).astype(np.uint8)
    img = Image.fromarray(idx, mode="P")
    img.putpalette(list(np.arange(48, dtype=np.uint8).repeat(16)))
    path = str(tmp_path / "p.png")
    img.save(path)
    np.testing.assert_array_equal(_equal(path)[..., 0], np.asarray(Image.open(path)))
    for scale in SCALES:
        np.testing.assert_array_equal(pio.read_rgb(path, scale),
                                      pio.read_rgb(path, scale, plain=True))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_reads_match_the_jax_native_tier(tmp_path, channels, depth):
    """``read_rgb`` (and ``read_depth_png`` of 16-bit gray) against the JAX
    package's libpng tier, which strips 16 bits to 8, expands gray and drops
    alpha as the port does."""
    assert jax_native_io.available(), "the JAX package's native tier must load here"
    dtype = np.uint16 if depth == 16 else np.uint8
    path = str(tmp_path / "x.png")
    write_png(path, _scene(H, W, channels, dtype, seed=3), filter_type=FILTERS["mixed"])
    for scale in SCALES:
        got, ref = pio.read_rgb(path, scale), jio.read_rgb(path, scale)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        if channels == 1 and depth == 16:
            np.testing.assert_array_equal(pio.read_depth_png(path, 5000.0, scale),
                                          jio.read_depth_png(path, 5000.0, scale))


def _rewrite_idat(path, rows):
    """Rewrite ``path``'s image data as ``rows`` (bytes, filter bytes
    included), with valid CRCs."""
    data = open(path, "rb").read()
    i = data.index(b"IDAT") - 4
    (length,) = struct.unpack(">I", data[i:i + 4])
    body = zlib.compress(rows)
    chunk = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(b"IDAT" + body))
    open(path, "wb").write(data[:i] + chunk + data[i + 12 + length:])


def test_bad_png_files_raise_naming_the_file(tmp_path):
    img = _scene(6, 5, 3, np.uint8)
    path = str(tmp_path / "bad.png")
    write_png(path, img)
    data = open(path, "rb").read()
    cases = {"cut": data[:len(data) - 20], "crc": data[:45] + bytes([data[45] ^ 1]) + data[46:]}
    for name, blob in cases.items():
        p = str(tmp_path / f"{name}.png")
        open(p, "wb").write(blob)
        for plain in (False, True):
            with pytest.raises(ValueError, match=f"{name}.png"):
                read_png(p, plain=plain)
    raw = np.concatenate([np.full((6, 1), 5, np.uint8), img.reshape(6, -1)], 1)
    _rewrite_idat(path, raw.tobytes())  # filter 5
    for plain in (False, True):
        with pytest.raises(ValueError, match="bad.png: unknown PNG row filter 5"):
            read_png(path, plain=plain)
    _rewrite_idat(path, raw[:5].tobytes())  # a row short
    for plain in (False, True):
        with pytest.raises(ValueError, match="bad.png: PNG image data has"):
            read_png(path, plain=plain)


# ------------------------------------------------------------------ JPEG

JPEG_SIZES = [(240, 320), (37, 53), (9, 3)]  # 640x480: test_jpeg_read_rgb_matches_numpy_and_cv2


def _jpeg_equal(path):
    got, ref = read_jpeg(path), read_jpeg(path, plain=True)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    return got


def _pil_jpeg(path, size, seed=0, **kw):
    Image.fromarray(_scene(*size, 3, np.uint8, seed=seed)).save(path, **kw)
    return path


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["h1v1", "h2v1", "h2v2"])
def test_pil_jpeg_decodes_as_numpy_and_cv2(tmp_path, size, sampling):
    sub = {"h1v1": 0, "h2v1": 1, "h2v2": 2}[sampling]
    _jpeg_equal(_pil_jpeg(str(tmp_path / "x.jpg"), size, quality=80, subsampling=sub))


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", ["h1v2", "restart", "gray"])
def test_cv2_jpeg_decodes_as_numpy_and_cv2(tmp_path, size, case):
    img = _scene(*size, 3, np.uint8, seed=1)
    params = {"h1v2": [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
              "restart": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
              "gray": [cv2.IMWRITE_JPEG_QUALITY, 75]}[case]
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, img[..., 0] if case == "gray" else img, params)
    got = _jpeg_equal(path)
    if case == "gray":
        assert np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("restart", [0, 1, 5])
def test_restart_intervals_decode_as_numpy_and_cv2(tmp_path, size, restart):
    """``chip_smoke.write_jpeg``, the ScanNet phase's writer (4:2:0)."""
    path = str(tmp_path / "r.jpg")
    chip_smoke.write_jpeg(path, _scene(*size, 3, np.uint8, seed=2), quality=75, restart=restart)
    _jpeg_equal(path)


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_optimised_tables_decode_as_numpy_and_cv2(tmp_path, size):
    _jpeg_equal(_pil_jpeg(str(tmp_path / "o.jpg"), size, seed=3, quality=70, optimize=True))


@pytest.mark.parametrize("size", JPEG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_16_bit_quantization_tables_decode_as_numpy_and_cv2(tmp_path, size):
    """Tables past 255 are written with 16-bit precision (and SOF1)."""
    table = [min(2 + 9 * k, 900) for k in range(64)]
    path = _pil_jpeg(str(tmp_path / "q.jpg"), size, seed=4, qtables=[table, table])
    data = open(path, "rb").read()
    assert data[data.index(b"\xff\xdb") + 4] >> 4 == 1 and b"\xff\xc1" in data
    _jpeg_equal(path)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_jpeg_read_rgb_matches_numpy_and_cv2(tmp_path, scale):
    """The JAX package's OpenCV branch of ``read_rgb``: ``imread``, ``/ 255``
    and ``cv2.resize``."""
    path = str(tmp_path / "c.jpg")
    chip_smoke.write_jpeg(path, _scene(480, 640, 3, np.uint8, seed=5), quality=75, restart=8)
    got = pio.read_rgb(path, scale)
    np.testing.assert_array_equal(got, pio.read_rgb(path, scale, plain=True))
    np.testing.assert_array_equal(got, jio.read_rgb(path, scale))


@pytest.mark.parametrize("scale", [0.5, 0.25, 0.3, 0.75])
@pytest.mark.parametrize("kind", ["noise", "bytes", "flat"])
def test_resize_linear_matches_numpy_and_cv2(scale, kind):
    """At 0.5 and 0.25 every weight is 0.5 and a product rounds exactly; at
    0.3 and 0.75 only a single rounding of ``p0 + (p1 - p0) w`` gives
    OpenCV's bits."""
    rng = np.random.RandomState(6)
    if kind == "noise":
        img = rng.rand(480, 640, 3).astype(np.float32)
    elif kind == "bytes":
        img = rng.randint(0, 256, (481, 643, 3)).astype(np.float32) / np.float32(255)
    else:  # neighbours a few ulps apart
        steps = rng.randint(-3, 4, (97, 131, 3)).astype(np.float32)
        img = np.float32(0.5) + steps * np.float32(2 ** -24)
    got = pio.resize_linear_cv(img, scale)
    np.testing.assert_array_equal(got, pio.resize_linear_cv(img, scale, plain=True))
    np.testing.assert_array_equal(got, cv2.resize(img, None, fx=scale, fy=scale))


def test_bad_jpeg_files_raise_naming_the_file(tmp_path):
    """Truncated data, a Huffman code no table holds, a bad table: the same
    ``ValueError`` from the native tier as from the numpy twin."""
    path = _pil_jpeg(str(tmp_path / "x.jpg"), (37, 53), quality=80)
    data = open(path, "rb").read()
    sos = data.index(b"\xff\xda")
    sos_end = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    dht = data.index(b"\xff\xc4")
    cases = {
        "cut.jpg": (data[:sos_end + 40], "JPEG data ends inside a block"),
        "code.jpg": (data[:sos_end] + b"\xff\x00" * 200 + b"\xff\xd9", "corrupt Huffman data"),
        # the first table's 1-bit codes: 3 cannot fit
        "table.jpg": (data[:dht + 5] + b"\x03" + data[dht + 6:], "bad Huffman table"),
    }
    for name, (blob, message) in cases.items():
        for plain in (False, True):
            with pytest.raises(ValueError, match=f"{name}: {message}"):
                decode_jpeg(blob, name, plain=plain)
    for plain in (False, True):  # a scan missing its Huffman tables
        with pytest.raises(ValueError, match="nt.jpg: missing Huffman table"):
            decode_jpeg(data[:dht] + data[dht + 2 + struct.unpack(">H", data[dht + 2:dht + 4])[0]:],
                        "nt.jpg", plain=plain)


# ------------------------------------------------------------ the library


def test_the_binding_is_a_cdll_that_drops_the_gil():
    """``ctypes.CDLL``, not ``PyDLL``: its calls release the GIL."""
    lib = native_io.library()
    assert type(lib) is ctypes.CDLL
    assert not lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert os.path.dirname(lib._name) == str(native_io.BUILD_DIR)
    assert "libdpft_io" not in lib._name


_BUILD_CHILD = """
import sys, pathlib
import numpy as np
from deep_prob_feature_track_torch.data import native_io
native_io.BUILD_DIR = pathlib.Path(sys.argv[1])
raw = np.array([[1, 10, 20, 30], [2, 1, 1, 1]], np.uint8)
out = native_io.png_unfilter(raw, 2, 1, 3, 8)
maps = open("/proc/self/maps").read()
print(out.ravel().tolist(), "libdpft_io" in maps, "libhost_io" in maps)
"""


def test_two_processes_that_build_at_once_both_load(tmp_path):
    """Both start with an empty build directory; the file lock makes one
    wait for the other's library, and neither loads the JAX package's."""
    build = str(tmp_path / "build")
    blocked = ("import sys\nfor m in ('jax', 'deep_prob_feature_track_tpu'):\n"
               "    sys.modules[m] = None\n")
    procs = [subprocess.Popen([sys.executable, "-c", blocked + _BUILD_CHILD, build], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        assert out.split() == ["[10,", "20,", "30,", "11,", "21,", "31]", "False", "True"]
    names = sorted(os.listdir(build))
    assert [n for n in names if n.endswith(".so")] == [n for n in names if n.startswith("lib")]
    assert len([n for n in names if n.endswith(".so")]) == 1
    assert not [n for n in names if n.endswith(".tmp")]


def test_a_missing_compiler_or_a_failed_build_raises(tmp_path, monkeypatch):
    source = tmp_path / "broken.cpp"
    source.write_text("int f() { return undeclared; }\n")
    with pytest.raises(RuntimeError, match="undeclared"):
        loader.build_host(source, tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        loader.build_host(source, tmp_path / "build")
