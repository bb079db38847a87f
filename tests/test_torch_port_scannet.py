"""PyTorch port vs the JAX package: the ScanNet dataset.

Fixtures (``chip_smoke.write_scannet_scan``, the ``write_tum_sequence``
scene at 640x480, colour written by the card's own baseline JPEG encoder):
a training scan of 8 frames whose frames 3 and 4 have an infinite pose
(tracking failures, dropped from the list, so some keyframe gaps need the
repair search) and a test scan of 6 frames under ``val/``.  The JAX
package decodes the colour through OpenCV and the depth through its native
tier; the port through ``data/jpeg.py`` and ``data/png.py``.  Items are
held equal bit for bit, with the global ``random`` seeded alike before each
package draws its keyframe gaps; the evaluate CLI's per-frame poses within
1e-5 of the JAX CLI's (a forward of the feature preset, as
``tests/test_torch_port_eval.py`` holds the TUM CLI).
"""

import os
import pickle
import random
import shutil

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.data import loader as ploader
from deep_prob_feature_track_torch.data import scannet as pscan
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_tpu.apps import evaluate as jev
from deep_prob_feature_track_tpu.data import loader as jloader
from deep_prob_feature_track_tpu.data import scannet as jscan
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.training import checkpoints as jck

torch.set_num_threads(2)
RESIZE = 0.1


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    chip_smoke.write_scannet_scan(str(root / "train" / "scene0000_00"), n=8, lost=(3, 4))
    chip_smoke.write_scannet_scan(str(root / "val" / "scene0565_00"), n=6, restart=0)
    return str(root)


@pytest.fixture
def fresh_root(root, tmp_path):
    """The scans without their ``sync_trajectory.pkl`` caches."""
    dst = tmp_path / "scannet"
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns("sync_trajectory.pkl"))
    return str(dst)


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def _items(mod, root, category, keyframes, seed=5):
    ds = mod.load_data("ScanNet", keyframes, category, image_resize=RESIZE, root=root,
                       augment_seed=3)
    random.seed(seed)
    return ds, [ds[i] for i in range(len(ds))]


def _validation_items(mod, root, keyframes, seed=5):
    """The validation split at ``subset_val`` 0.5 (the default 0.05 of six
    views is one view, no pair)."""
    ds = mod.ScanNet(root, "validation", keyframes, image_resize=RESIZE, subset_val=0.5)
    random.seed(seed)
    return ds, [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("category,keyframes", [("train", [1, 2, 4]), ("validation", [1, 2]),
                                                ("test", [2])])
def test_items_match_jax(root, category, keyframes):
    if category == "validation":
        got_ds, got = _validation_items(pscan, root, keyframes)
        ref_ds, ref = _validation_items(jscan, root, keyframes)
    else:
        got_ds, got = _items(ploader, root, category, keyframes)
        ref_ds, ref = _items(jloader, root, category, keyframes)
    assert len(got) == len(ref) > 0
    assert got_ds.frame_id_seq == ref_ds.frame_id_seq and got_ds.seq_names == ref_ds.seq_names
    for a, b in zip(got, ref):
        _equal_items(a, b)
    assert got[0]["color0"].shape == (3, 48, 64) and got[0]["depth0"].shape == (1, 48, 64)


def test_dropped_frames_take_the_gap_repair(root):
    """Frames 3 and 4 are gone: a drawn gap that spans them is repaired to
    a nearer frame, in both packages alike (the same draws)."""
    ds, items = _items(ploader, root, "train", [1, 2, 4], seed=11)
    assert ds.frame_id_seq[0] == [0, 1, 2, 5, 6]  # the first 95% of the six views
    frames = {(it["name"]["frame0"], it["name"]["frame1"]) for it in items}
    ids = ds.frame_id_seq[0]
    assert all(abs(ids[j] - ids[i]) <= 4 for i, j in frames)
    _, ref = _items(jloader, root, "train", [1, 2, 4], seed=11)
    assert [it["name"] for it in items] == [it["name"] for it in ref]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sync_cache_is_read_by_the_other_package(fresh_root, writer):
    scan = os.path.join(fresh_root, "train", "scene0000_00")
    first, second = (pscan, jscan) if writer == "port" else (jscan, pscan)
    views = first.read_scan(scan)
    assert os.path.isfile(os.path.join(scan, "sync_trajectory.pkl"))
    again = second.read_scan(scan)
    assert [v["frame_id"] for v in views] == [v["frame_id"] for v in again] == [0, 1, 2, 5, 6, 7]
    for a, b in zip(views, again):
        assert a["img"] == b["img"] and a["dpt"] == b["dpt"]
        np.testing.assert_array_equal(a["pose"], b["pose"])
    with open(os.path.join(scan, "sync_trajectory.pkl"), "rb") as f:
        assert isinstance(pickle.load(f), list)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("w")
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    jck.save_variables(str(d / "w.msgpack"), v)
    checkpoints.save_variables(str(d / "w.pt"), port.state_dict())
    return str(d / "w.pt"), str(d / "w.msgpack")


def test_evaluate_cli_matches_jax(root, weights, tmp_path, capsys):
    pt, msgpack = weights
    common = ["--dataset", "ScanNet", "--data_root", root, "--trajectory", "scene0565_00",
              "--keyframes", "1,2", "--batch_size", "2", "--image_resize", str(RESIZE)]
    with jax.enable_x64(False):
        assert jev.main([*common, "--checkpoint", msgpack,
                         "--output_dir", str(tmp_path / "jax")]) == 0
    ref_out = capsys.readouterr().out
    assert pev.main([*common, "--checkpoint", pt, "--output_dir", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    for n in (5, 2):  # keyframe 1: 5 pairs of 6 frames; keyframe 2: 2 pairs of 3
        assert f"({n} frames)" in got_out and f"({n} frames)" in ref_out
    for kf in (1, 2):
        name = f"scene0565_00_keyframe_{kf}.pkl"
        with open(tmp_path / "jax" / "w" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / "w" / name, "rb") as f:
            have = pickle.load(f)
        assert have["names"] == want["names"]
        for key in ("R_est", "t_est"):
            np.testing.assert_allclose(have[key], want[key], atol=1e-5, rtol=0)
        np.testing.assert_allclose(have["epes"], want["epes"], rtol=1e-4, atol=1e-7)


def test_train_cli_takes_a_step(root, tmp_path, monkeypatch, capsys):
    from deep_prob_feature_track_torch.utils import logger as plogger

    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)  # TensorFlow's import
    assert ptr.main(["--dataset", "ScanNet", "--data_root", root, "--keyframes", "1,2",
                     "--batch_size", "2", "--image_resize", str(RESIZE), "--epochs", "1",
                     "--max_steps_per_epoch", "1", "--no_val", "--checkpoint_folder",
                     str(tmp_path / "logs"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out and "step=1)" in out
    loss = float(out.split("epoch 0: loss=")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
