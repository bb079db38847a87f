"""PyTorch port vs the JAX package: the TUM data layer, on numpy alone.

Fixtures are written in ``tmp_path``: PNG files through PIL (whose encoder
picks each row's filter itself), and through ``chip_smoke.write_png``
where a test needs a given filter on every row.  Tolerances: none.  The
PNG decoder equals PIL's samples; ``read_rgb`` and ``read_depth_png`` equal
the JAX package's native tier (``native/libdpft_io.so``, the tier its
``data/io.py`` takes wherever that library loads) bit for bit, since both
blend in float32 in the same order; ``TUM`` items, ``BatchLoader`` batches
and the ``sync_trajectory.pkl`` cache equal the JAX package's, array for
array.
"""

import os
import pickle
import random
import shutil
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch.data import association as pa
from deep_prob_feature_track_torch.data import io as pio
from deep_prob_feature_track_torch.data import loader as ploader
from deep_prob_feature_track_torch.data import pipeline as pp
from deep_prob_feature_track_torch.data import tum as ptum
from deep_prob_feature_track_torch.data.png import read_png
from deep_prob_feature_track_torch.data.transforms import ColorAugment
from deep_prob_feature_track_tpu.data import association as ja
from deep_prob_feature_track_tpu.data import io as jio
from deep_prob_feature_track_tpu.data import native_io
from deep_prob_feature_track_tpu.data import pipeline as jp
from deep_prob_feature_track_tpu.data import tum as jtum
from deep_prob_feature_track_tpu.data.transforms import ColorAugment as JaxColorAugment

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_png  # noqa: E402

torch.set_num_threads(2)
N_FRAMES, H, W = 40, 60, 80


def _image(rng, shape, dtype):
    hi = 65536 if dtype == np.uint16 else 256
    return rng.randint(0, hi, shape).astype(dtype)


def _write_sequence(seq_dir, n=N_FRAMES, seed=0):
    """A TUM-format sequence of smooth HxW frames written with PIL, and a
    trajectory of small motions."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(seq_dir, "rgb"))
    os.makedirs(os.path.join(seq_dir, "depth"))
    y, x = np.mgrid[0:H, 0:W]
    rgb, dep, gt = [], [], []
    for i in range(n):
        stamp = f"{10.0 + i / 30:.6f}"
        color = 120 + 100 * np.sin(x[..., None] / 7.0 + i * 0.3 + np.arange(3)) * np.cos(
            y[..., None] / 5.0) + rng.randint(-10, 10, (H, W, 3))
        Image.fromarray(np.clip(color, 0, 255).astype(np.uint8)).save(
            os.path.join(seq_dir, "rgb", f"{stamp}.png"))
        depth = (2000 + 40 * x + 30 * y + rng.randint(0, 50, (H, W))).astype(np.int32)
        depth[rng.rand(H, W) < 0.05] = 0  # holes, which the clip raises to 0.5 m
        Image.fromarray(depth, mode="I").convert("I;16").save(
            os.path.join(seq_dir, "depth", f"{stamp}.png"))
        rgb.append(f"{stamp} rgb/{stamp}.png")
        dep.append(f"{stamp} depth/{stamp}.png")
        q = np.array([0.01 * i, -0.02 * i, 0.005 * i, 1.0])
        q /= np.linalg.norm(q)
        gt.append(" ".join([stamp, *(f"{v:.6f}" for v in (0.01 * i, 0.002 * i, -0.01 * i, *q))]))
    for name, lines in (("rgb", rgb), ("depth", dep), ("groundtruth", gt)):
        with open(os.path.join(seq_dir, f"{name}.txt"), "w") as f:
            f.write("# timestamp data\n" + "\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    _write_sequence(str(root / "seq"))
    return str(root)


@pytest.fixture
def one_sequence(monkeypatch):
    """Both packages' train and test splits name the fixture's sequence."""
    for mod in (ptum, jtum):
        monkeypatch.setattr(mod, "TUM_TRAINVAL", {"fx": ["seq"]})
        monkeypatch.setattr(mod, "TUM_TEST", {"fx": ["seq"]})


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


# ------------------------------------------------------------------ PNG


KINDS = {  # colour type, the array written
    "gray8": lambda rng: _image(rng, (7, 9), np.uint8),
    "gray_alpha8": lambda rng: _image(rng, (7, 9, 2), np.uint8),
    "rgb8": lambda rng: _image(rng, (7, 9, 3), np.uint8),
    "rgba8": lambda rng: _image(rng, (7, 9, 4), np.uint8),
    "gray16": lambda rng: _image(rng, (7, 9), np.uint16),
}


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_png_decoder_matches_pil(tmp_path, rng, kind, filter_type):
    img = KINDS[kind](rng)
    path = str(tmp_path / "x.png")
    write_png(path, img, np.arange(7) % 5 if filter_type == "mixed" else filter_type)
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(ref, img)
    got = read_png(path)
    assert got.dtype == img.dtype and got.shape == ref.shape + (1,) * (ref.ndim == 2)
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("filter_type", [1, 4])
def test_png_rgb16_keeps_the_high_byte(tmp_path, rng, filter_type):
    """16-bit RGB: the samples as written; ``read_rgb`` keeps their high
    byte, as PIL's RGB and libpng's ``png_set_strip_16`` (the JAX native
    tier) do."""
    img = _image(rng, (6, 11, 3), np.uint16)
    path = str(tmp_path / "x.png")
    write_png(path, img, filter_type)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img >> 8)
    np.testing.assert_array_equal(pio.read_rgb(path), jio.read_rgb(path))


def test_png_refuses_palette_interlace_and_corruption(tmp_path, rng):
    """An 8-bit palette file decodes to its indices, as PIL reads it; one
    of 4 bits is refused."""
    palette = str(tmp_path / "palette.png")
    Image.fromarray(_image(rng, (5, 6), np.uint8)).convert("P").save(palette)
    np.testing.assert_array_equal(read_png(palette)[..., 0], np.asarray(Image.open(palette)))
    data = bytearray(open(palette, "rb").read())
    data[24] = 4  # IHDR's bit depth; then its CRC again
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(palette, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="palette.png: PNG colour type 3 at 4 bits"):
        read_png(palette)
    path = str(tmp_path / "interlaced.png")
    write_png(path, _image(rng, (5, 6, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR's interlace byte; then its CRC again
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        read_png(path)
    data[20] ^= 1  # a corrupt IHDR
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        read_png(path)


@pytest.mark.parametrize("scale", [1.0, 0.25, 0.1])
def test_read_rgb_and_depth_match_the_jax_native_tier(tmp_path, rng, scale):
    assert native_io.available(), "the JAX package's native tier must load here"
    rgb, depth = str(tmp_path / "rgb.png"), str(tmp_path / "depth.png")
    Image.fromarray(_image(rng, (480, 640, 3), np.uint8)).save(rgb)
    d = rng.randint(0, 30000, (480, 640)).astype(np.int32)
    Image.fromarray(d, mode="I").convert("I;16").save(depth)
    got, ref = pio.read_rgb(rgb, scale), jio.read_rgb(rgb, scale)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for clip in ((0.5, 5.0), None):
        got, ref = pio.read_depth_png(depth, 5000.0, scale, clip), jio.read_depth_png(
            depth, 5000.0, scale, clip)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------- TUM items


def test_sync_trajectory_cache_is_shared(tmp_path, root):
    seq = os.path.join(root, "seq")
    for write, read in ((ja.write_sync_trajectory, pa.load_sync_trajectory),
                        (pa.write_sync_trajectory, ja.load_sync_trajectory)):
        copy = str(tmp_path / write.__module__.split(".")[0])
        shutil.copytree(seq, copy)
        path = write(copy)
        with open(path, "rb") as f:
            written = pickle.load(f)
        assert read(copy) == written and len(written) == N_FRAMES
        assert written[0][1] == os.path.join(copy, "rgb", "10.000000.png")
    assert pa.associate_three({1.0: ["a"], 2.0: ["b"]}, {1.01: ["c"], 2.5: ["d"]},
                              {0.995: ["e"]}) == [(1.0, 1.01, 0.995)]
    np.testing.assert_array_equal(pa.tq_to_matrix4([1, 2, 3, 0.1, 0.2, 0.3, 0.9]),
                                  ja.tq_to_matrix4([1, 2, 3, 0.1, 0.2, 0.3, 0.9]))


def test_tum_train_items_with_augment_match_jax(root, one_sequence):
    kw = dict(root=root, category="train", keyframes=[1, 2], image_resize=0.25)
    got = ptum.TUM(augment=ColorAugment(seed=3), **kw)
    ref = jtum.TUM(augment=JaxColorAugment(seed=3), **kw)
    assert len(got) == len(ref) == int(0.95 * N_FRAMES) - 2
    random.seed(11)
    got_items = [got[i] for i in range(len(got))]
    random.seed(11)
    ref_items = [ref[i] for i in range(len(ref))]
    gaps = {it["name"]["frame1"] - it["name"]["frame0"] for it in got_items}
    assert gaps == {1, 2}
    for a, b in zip(got_items, ref_items):
        _equal_items(a, b)
    assert got_items[0]["color0"].shape == (3, H // 4, W // 4)


@pytest.mark.parametrize("category,keyframes", [("validation", [1]), ("test", [2])])
def test_tum_eval_items_match_jax(root, one_sequence, category, keyframes):
    kw = dict(root=root, category=category, keyframes=keyframes, image_resize=0.5)
    got, ref = ptum.TUM(**kw), jtum.TUM(**kw)
    assert len(got) == len(ref) > 0
    for i in range(len(got)):
        _equal_items(got[i], ref[i])
    if category == "test":
        assert len(got) == N_FRAMES // 2 - 1
        _equal_items(got.get_keypair(5, kf_idx=2), ref.get_keypair(5, kf_idx=2))
        _equal_items(got.pair_frames(3, 7), ref.pair_frames(3, 7))
        assert got.num_frames() == ref.num_frames() == N_FRAMES // 2


def test_tum_custom_folder_matches_jax(root):
    seq = os.path.join(root, "seq")
    got = ploader.load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=0.1,
                            root="")
    ref = jtum.TUM(root="", category="test", keyframes=[1], select_traj=seq, image_resize=0.1)
    assert len(got) == len(ref) == N_FRAMES - 1 and got.seq_names == ["seq"]
    for i in (0, 17, len(got) - 1):
        _equal_items(got[i], ref[i])
    _equal_items(got.get_keypair(9), ref.get_keypair(9))


# --------------------------------------------------------------- batching


@pytest.mark.parametrize("shuffle,drop_last,num_shards", [
    (False, False, 1), (True, False, 1), (True, True, 1), (True, False, 2)])
def test_batch_loader_matches_jax(root, shuffle, drop_last, num_shards):
    seq = os.path.join(root, "seq")
    kw = dict(root="", category="test", keyframes=[3], select_traj=seq, image_resize=0.25)
    got_ds, ref_ds = ptum.TUM(**kw), jtum.TUM(**kw)
    assert len(got_ds) == 13
    for shard in range(num_shards):
        lk = dict(batch_size=4, shuffle=shuffle, seed=7, drop_last=drop_last,
                  shard_index=shard, num_shards=num_shards)
        got, ref = pp.BatchLoader(got_ds, **lk), jp.BatchLoader(ref_ds, **lk)
        got_batches, ref_batches = list(got), list(ref)
        assert len(got) == len(ref) == len(got_batches) == len(ref_batches) > 0
        for a, b in zip(got_batches, ref_batches):
            _equal_items(a, b)
        n = len(range(shard, len(got_ds), num_shards))
        pads = np.concatenate([b["pad_mask"] for b in got_batches])
        assert (~pads).sum() == (0 if drop_last else -n % 4)


def test_batch_loader_stops_its_prefetch_thread(root):
    ds = ptum.TUM(root="", category="test", keyframes=[1],
                  select_traj=os.path.join(root, "seq"), image_resize=0.25)
    before = threading.active_count()
    it = iter(pp.BatchLoader(ds, batch_size=2, prefetch=2))
    first = next(it)
    assert threading.active_count() == before + 1
    it.close()  # the caller stops after one batch: the worker is joined
    assert threading.active_count() == before
    assert first["color0"].shape == (2, 3, H // 4, W // 4)


def test_to_device_moves_arrays_only(root):
    ds = ptum.TUM(root="", category="test", keyframes=[1],
                  select_traj=os.path.join(root, "seq"), image_resize=0.25)
    batch = next(iter(pp.BatchLoader(ds, batch_size=3, prefetch=0)))
    moved = pp.to_device(batch, "cpu")
    assert moved["pad_mask"] is batch["pad_mask"] and moved["name"] is batch["name"]
    for key in ("color0", "depth1", "transform", "calib"):
        assert isinstance(moved[key], torch.Tensor)
        np.testing.assert_array_equal(moved[key].numpy(), batch[key])


# ---------------------------------------------------------- dataset roots


def test_dataset_roots_and_unported_datasets(monkeypatch):
    assert ploader.get_dataset_root("TUM_RGBD", "/x") == "/x"
    monkeypatch.setenv("DPFT_DATA_ROOT", "/data")
    assert ploader.get_dataset_root("TUM_RGBD") == os.path.join("/data", "TUM_RGBD")
    monkeypatch.delenv("DPFT_DATA_ROOT")
    assert ploader.get_dataset_root("TUM_RGBD") == "/data/TUM_RGBD"  # setup/datasets.yaml
    monkeypatch.setitem(sys.modules, "yaml", None)  # a machine without PyYAML
    with pytest.raises(ImportError, match="--data_root"):
        ploader.get_dataset_root("TUM_RGBD")
    # ScanNet is ported: the loader routes it, and it lists the root's scans
    with pytest.raises(FileNotFoundError, match="/x/train"):
        ploader.load_data("ScanNet", [1], root="/x")
    with pytest.raises(ValueError, match="unsupported dataset"):
        ploader.load_data("KITTI", [1], root="/x")
    # VaryLighting is ported: a root without scenes gives an empty dataset
    assert len(ploader.load_data("VaryLighting", [1], "test", root="/x")) == 0
