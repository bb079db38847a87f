"""The port's JPEG decoder (``data/jpeg.py``) against ``cv2.imread`` bit for
bit, and ``read_rgb`` of a JPEG against the JAX package's, whose OpenCV
branch it copies.

The files are written by PIL (sizes 640x480, 37x53 and 8x8; qualities 50,
75 and 95; 4:4:4, 4:2:2 and 4:2:0 chroma; optimised Huffman tables),
by OpenCV (a restart interval, 4:4:0 chroma, grayscale) and by
``chip_smoke.encode_jpeg``, the card's own writer (4:2:0 with restart
markers).  The images are a smooth texture plus noise, so that every
coefficient category and the range limits occur.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from deep_prob_feature_track_torch.data import io as pio
from deep_prob_feature_track_torch.data.jpeg import decode_jpeg, read_jpeg
from deep_prob_feature_track_tpu.data import io as jio

SIZES = [(480, 640), (37, 53), (8, 8)]


def _scene(h, w, seed=0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def _cv2(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_pil_files_decode_as_cv2(tmp_path, size, quality, subsampling):
    path = tmp_path / "x.jpg"
    Image.fromarray(_scene(*size)).save(path, quality=quality, subsampling=subsampling)
    got = read_jpeg(str(path))
    assert got.dtype == np.uint8 and got.shape == size + (3,)
    np.testing.assert_array_equal(got, _cv2(path))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_optimised_tables_decode_as_cv2(tmp_path, size):
    path = tmp_path / "x.jpg"
    Image.fromarray(_scene(*size, seed=1)).save(path, quality=80, optimize=True)
    np.testing.assert_array_equal(read_jpeg(str(path)), _cv2(path))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("params", [
    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
], ids=["restart", "h1v2"])
def test_cv2_files_decode_as_cv2(tmp_path, size, params):
    path = tmp_path / "x.jpg"
    assert cv2.imwrite(str(path), _scene(*size, seed=2), params)
    np.testing.assert_array_equal(read_jpeg(str(path)), _cv2(path))


@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_grayscale_expands_to_three_equal_channels(tmp_path, writer):
    path = tmp_path / "g.jpg"
    gray = _scene(37, 53, seed=3)[..., 0]
    if writer == "pil":
        Image.fromarray(gray).save(path, quality=70)
    else:
        cv2.imwrite(str(path), gray)
    got = read_jpeg(str(path))
    np.testing.assert_array_equal(got, _cv2(path))
    assert np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("restart", [0, 5])
def test_chip_smoke_encoder_output_decodes_as_cv2(tmp_path, size, restart):
    path = tmp_path / "e.jpg"
    img = _scene(*size, seed=4)
    chip_smoke.write_jpeg(str(path), img, quality=90, restart=restart)
    got = read_jpeg(str(path))
    np.testing.assert_array_equal(got, _cv2(path))
    smooth = cv2.GaussianBlur(img, (0, 0), 2.0)  # the encoder keeps a smooth image
    chip_smoke.write_jpeg(str(path), smooth, quality=90, restart=restart)
    assert np.abs(read_jpeg(str(path)).astype(int) - smooth).mean() < 3.0


def test_unsupported_files_raise_naming_the_file(tmp_path):
    img = Image.fromarray(_scene(37, 53))
    path = tmp_path / "progressive.jpg"
    img.save(path, progressive=True)
    with pytest.raises(ValueError, match="progressive.jpg: progressive"):
        read_jpeg(str(path))
    cmyk = tmp_path / "cmyk.jpg"
    img.convert("CMYK").save(cmyk)
    with pytest.raises(ValueError, match="cmyk.jpg: .*4 components"):
        read_jpeg(str(cmyk))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    data = buf.getvalue()
    with pytest.raises(ValueError, match="x.jpg: not a JPEG"):
        decode_jpeg(data[2:], "x.jpg")
    with pytest.raises(ValueError, match="cut.jpg"):
        decode_jpeg(data[:len(data) // 3], "cut.jpg")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_read_rgb_of_a_jpeg_matches_jax(tmp_path, size, scale):
    """The JAX package's OpenCV branch: BGR -> RGB, ``/ 255.0`` in float32,
    ``cv2.resize`` with ``INTER_LINEAR``; the port holds its bits."""
    path = tmp_path / "c.jpg"
    Image.fromarray(_scene(*size, seed=5)).save(path, quality=85)
    got = pio.read_rgb(str(path), scale)
    ref = jio.read_rgb(str(path), scale)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scale", [0.3, 0.1, 0.75])
def test_resize_linear_matches_cv2_at_other_downscales(scale):
    img = _scene(480, 640, seed=6).astype(np.float32) / np.float32(255)
    np.testing.assert_array_equal(pio.resize_linear_cv(img, scale),
                                  cv2.resize(img, None, fx=scale, fy=scale))
