"""PyTorch port vs the JAX package: ``data/simple.py``,
``apps/run_example.py``, ``data/vary_lighting.py``, TUM's
``add_vl_dataset`` and evaluation without ground truth.

Fixtures: a 640x480 TUM-format sequence of 4 frames
(``chip_smoke.write_tum_sequence``), whose ``rgb/`` and ``depth/`` folders
also serve as ``run_example``'s folders and, copied, as two VaryLighting
scenes (4 and 3 frames).  The ``feature`` weights are the port's seeded
init, carried to the JAX package by its ``convert_state_dict``; the JAX
functions run with x64 off, as on their device.

Tolerances: items, batches and file lists equal; ``resize_batch``'s colour
within 1e-6 (K1's plain version against the JAX gather, one float32
blend), depth and intrinsics equal; ``run_example``'s printed poses (eight
significant digits) and the evaluate CLI's per-frame poses within 1e-5 (a
forward of the feature preset, as ``tests/test_torch_port_eval.py``
holds it); ``summarize_results``' table 1e-12 relative, its CSV text
equal.
"""

import os
import pickle
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch import evaluation as pe
from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.apps import run_example as prun
from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.data import loader as ploader
from deep_prob_feature_track_torch.data import pipeline as pp
from deep_prob_feature_track_torch.data import tum as ptum
from deep_prob_feature_track_torch.data.simple import SimpleLoader as PSimple
from deep_prob_feature_track_torch.data.vary_lighting import VaryLighting as PVL
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_tpu import evaluation as je
from deep_prob_feature_track_tpu.apps import evaluate as jev
from deep_prob_feature_track_tpu.apps import run_example as jrun
from deep_prob_feature_track_tpu.data import loader as jloader
from deep_prob_feature_track_tpu.data import pipeline as jpipe
from deep_prob_feature_track_tpu.data import tum as jtum
from deep_prob_feature_track_tpu.data.simple import SimpleLoader as JSimple
from deep_prob_feature_track_tpu.data.vary_lighting import VaryLighting as JVL
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.training import checkpoints as jck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
KEYS = ("color0", "color1", "depth0", "depth1", "calib")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tum") / "seq")
    write_tum_sequence(path, n=4)
    return path


@pytest.fixture(scope="module")
def vl_root(seq, tmp_path_factory):
    """Two VaryLighting scenes: ``scene0`` (4 frames) and ``scene1`` (the
    first 3), no ground truth."""
    root = tmp_path_factory.mktemp("vl")
    for scene, n in (("scene0", 4), ("scene1", 3)):
        for sub in ("rgb", "depth"):
            os.makedirs(root / scene / sub)
            for name in sorted(os.listdir(os.path.join(seq, sub)))[:n]:
                shutil.copy(os.path.join(seq, sub, name), root / scene / sub / name)
    return str(root)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("w")
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    jck.save_variables(str(d / "w.msgpack"), v)
    checkpoints.save_variables(str(d / "w.pt"), port.state_dict())
    return str(d / "w.pt"), str(d / "w.msgpack")


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


# ------------------------------------------------------------ SimpleLoader


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_simple_loader_items_match_jax(seq, scale):
    args = (os.path.join(seq, "rgb"), os.path.join(seq, "depth"), [525.0, 525.0, 319.5, 239.5])
    got, ref = PSimple(*args, image_resize=scale), JSimple(*args, image_resize=scale)
    assert len(got) == len(ref) == 3
    for i in range(3):
        _equal_items(got[i], ref[i])
    assert got[0]["color0"].shape == (3, int(480 * scale), int(640 * scale))


# ---------------------------------------------------------------- run_example


@pytest.mark.parametrize("size", [(480, 640), (437, 611), (120, 160)])
def test_resize_batch_matches_jax(rng, size):
    """At 437x611 the nearest rows ``int(i * (437 / 120))`` are taken in
    float32, as the JAX function takes them with x64 off."""
    h, w = size
    batch = {"color0": rng.rand(2, 3, h, w).astype(np.float32),
             "color1": rng.rand(2, 3, h, w).astype(np.float32),
             "depth0": rng.rand(2, 1, h, w).astype(np.float32) + 0.5,
             "depth1": rng.rand(2, 1, h, w).astype(np.float32) + 0.5,
             "calib": np.tile(np.float32([525.0, 525.0, 319.5, 239.5]), (2, 1))}
    got = prun.resize_batch(batch, device="cpu")
    with jax.enable_x64(False):
        ref = jrun.resize_batch(batch)
    for name, g, r in zip(KEYS, got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        if name.startswith("color"):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert got[0].shape == (2, 3, 120, 160)


def _printed_poses(text):
    """The numbers of each pair's printed rotation and translation."""
    pairs = re.split(r"pair \d+:", text)[1:]
    return [np.asarray([float(x) for x in re.findall(r"-?\d+\.\d*(?:e[-+]\d+)?", p)])
            for p in pairs]


def test_run_example_matches_jax(seq, weights, capsys):
    pt, msgpack = weights
    common = ["--color_dir", os.path.join(seq, "rgb"), "--depth_dir", os.path.join(seq, "depth")]
    with jax.enable_x64(False):
        assert jrun.main([*common, "--checkpoint", msgpack]) == 0
    ref = _printed_poses(capsys.readouterr().out)
    assert prun.main([*common, "--checkpoint", pt, "--device", "cpu"]) == 0
    got = _printed_poses(capsys.readouterr().out)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (12,)
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
    assert prun.main([*common, "--device", "cpu"]) == 0  # seeded init
    assert "no checkpoint given" in capsys.readouterr().out


# ---------------------------------------------------------------- VaryLighting


@pytest.mark.parametrize("category,keyframes,select", [
    ("test", [1], None), ("test", [2], "scene0"), ("keyframe", [3], "scene1")])
def test_vary_lighting_items_match_jax(vl_root, category, keyframes, select):
    kw = dict(root=vl_root, category=category, keyframes=keyframes, select_traj=select,
              image_resize=0.25)
    got, ref = PVL(**kw), JVL(**kw)
    assert len(got) == len(ref) > 0
    assert got.image_seq == ref.image_seq and got.seq_names == ref.seq_names
    for i in range(len(ref)):
        _equal_items(got[i], ref[i])
        assert "transform" not in got[i]
    _equal_items(got.get_keypair(len(got) - 1), ref.get_keypair(len(ref) - 1))
    _equal_items(got.pair_frames(0, 1), ref.pair_frames(0, 1))
    assert got.num_frames() == ref.num_frames()


def test_vary_lighting_loader_and_batches_match_jax(vl_root):
    got = ploader.load_data("VaryLighting", [1], "keyframe", root=vl_root, image_resize=0.25)
    ref = jloader.load_data("VaryLighting", [1], "keyframe", root=vl_root, image_resize=0.25)
    assert isinstance(got, PVL) and len(got) == len(ref) == 5
    for g, r in zip(pp.BatchLoader(got, 2, prefetch=0), jpipe.BatchLoader(ref, 2, prefetch=0)):
        _equal_items(g, r)
    with pytest.raises(AssertionError):  # test and keyframe categories only
        ploader.load_data("VaryLighting", [1], "train", root=vl_root)


def test_tum_add_vl_dataset_matches_jax(seq, monkeypatch, tmp_path):
    """``add_vl_dataset`` reads the varying-lighting sequences, TUM-format
    folders under the same root, into the train and validation lists."""
    for name in ("seq", "vl_seq"):
        os.symlink(seq, tmp_path / name)
    for mod in (ptum, jtum):
        monkeypatch.setattr(mod, "TUM_TRAINVAL", {"fx": ["seq"]})
        monkeypatch.setattr(mod, "VARY_LIGHTING_TRAINVAL", {"vl": ["vl_seq"]})
    for category in ("train", "validation"):
        for add in (False, True):
            kw = dict(root=str(tmp_path), category=category, keyframes=[1], image_resize=0.25,
                      add_vl_dataset=add)
            got, ref = ptum.TUM(**kw), jtum.TUM(**kw)
            assert got.seq_names == ref.seq_names == (["seq", "vl_seq"] if add else ["seq"])
            assert got.image_seq == ref.image_seq and len(got) == len(ref)
            if len(ref):
                _equal_items(got[len(ref) - 1], ref[len(ref) - 1])


# ------------------------------------------------ evaluation without ground truth


def _identity(module):
    def forward(c0, *_):
        B = c0.shape[0]
        return module.tile(module.eye(3)[None], (B, 1, 1)), module.zeros((B, 3))

    return forward


def test_evaluate_two_view_and_summary_without_ground_truth(vl_root, tmp_path):
    """Poses and names alone from a loader without ``transform``; the
    summary keeps its row with NaN metrics and takes the means as pandas
    does beside a loader with ground truth (NaN skipped; the frame-weighted
    mean of NaN alone is 0)."""
    kw = dict(trajectory="scene0", image_resize=0.25, root=vl_root)
    ploaders = pe.create_eval_loaders("VaryLighting", "test", [1], 3, **kw)
    jloaders = je.create_eval_loaders("VaryLighting", "test", [1], 3, **kw)
    (key,) = ploaders
    got = pe.evaluate_two_view(ploaders[key], _identity(torch), "cpu")
    ref = je.evaluate_two_view(jloaders[key], _identity(jnp))
    assert set(got) == set(ref) == {"R_est", "t_est", "names"}
    assert got["names"] == ref["names"] and len(got["names"]) == 3
    np.testing.assert_array_equal(got["R_est"], np.asarray(ref["R_est"], np.float32))
    rng = np.random.RandomState(0)
    with_gt = {"R_est": got["R_est"], "t_est": got["t_est"], "names": got["names"],
               **{k: rng.rand(3) for k in ("epes", "angular_error", "translation_error")}}
    for results, kfs in (({key: got}, [1]),
                         ({key: got, "other_keyframe_1": with_gt}, [1]),
                         ({key: got, "other_keyframe_2": with_gt}, [1, 2])):
        table = pe.summarize_results(results, kfs, output_csv=str(tmp_path / "p.csv"))
        df = je.summarize_results(results, kfs, output_csv=str(tmp_path / "j.csv"))
        assert list(table) == list(df.index)
        for name, row in table.items():
            for col in pe.COLUMNS:
                want = df.loc[name, col]
                have = row.get(col, float("nan"))
                if isinstance(want, str):
                    assert have == want
                elif want != want:
                    assert have != have, (name, col)
                else:
                    np.testing.assert_allclose(float(have), float(want), rtol=1e-12)
        assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert table[key]["total frames"] == 3 and table[key]["3D EPE"] != table[key]["3D EPE"]


def test_evaluate_cli_on_vary_lighting_matches_jax(vl_root, weights, tmp_path, capsys):
    pt, msgpack = weights
    common = ["--dataset", "VaryLighting", "--data_root", vl_root, "--trajectory", "scene0",
              "--keyframes", "1,2", "--batch_size", "2", "--image_resize", "0.1"]
    with jax.enable_x64(False):
        assert jev.main([*common, "--checkpoint", msgpack,
                         "--output_dir", str(tmp_path / "jax")]) == 0
    ref_out = capsys.readouterr().out
    assert pev.main([*common, "--checkpoint", pt, "--output_dir", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    for n in (3, 1):  # keyframe 1: 3 pairs of 4 frames; keyframe 2: 1 pair of 2
        line = f"no ground truth; {n} poses estimated"
        assert line in got_out and line in ref_out
    ref = (tmp_path / "jax" / "w" / "summary.csv").read_text()
    assert (tmp_path / "port" / "w" / "summary.csv").read_text() == ref
    assert "scene0_keyframe_1,,,,3,1,scene0" in ref
    for kf in (1, 2):
        with open(tmp_path / "jax" / "w" / f"scene0_keyframe_{kf}.pkl", "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / "w" / f"scene0_keyframe_{kf}.pkl", "rb") as f:
            have = pickle.load(f)
        assert set(have) == set(want) == {"R_est", "t_est", "names"}
        assert have["names"] == want["names"]
        for name in ("R_est", "t_est"):
            np.testing.assert_allclose(have[name], want[name], atol=1e-5, rtol=0)


def test_train_cli_on_vary_lighting_stops_as_the_jax_cli(vl_root, tmp_path, monkeypatch):
    """Its loader takes the test and keyframe categories only: the JAX CLI
    stops in ``load_data(..., "train")`` with the loader's
    ``AssertionError`` (its flax init comes first and takes ~20 s here, so
    the JAX loader is called alone)."""
    from deep_prob_feature_track_torch.utils import logger as plogger

    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)  # TensorFlow's import
    with pytest.raises(AssertionError):
        jloader.load_data("VaryLighting", [1], "train", root=vl_root)
    with pytest.raises(AssertionError):
        ptr.main(["--dataset", "VaryLighting", "--data_root", vl_root, "--epochs", "1",
                  "--no_val", "--checkpoint_folder", str(tmp_path / "port"), "--device", "cpu"])


def test_scannet_loads_in_the_loader_and_both_clis(tmp_path, monkeypatch, capsys):
    """ScanNet is ported (``tests/test_torch_port_scannet.py`` holds it to
    the JAX package): the loader reads a written scan, and both CLIs run on
    it."""
    from chip_smoke import write_scannet_scan
    from deep_prob_feature_track_torch.utils import logger as plogger

    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)  # TensorFlow's import
    root = tmp_path / "scannet"
    for split in ("train", "val"):
        write_scannet_scan(str(root / split / "scene0011_00"), n=4)
    assert len(ploader.load_data("ScanNet", [1], "test", root=str(root))) == 3
    assert pev.main(["--dataset", "ScanNet", "--data_root", str(root), "--trajectory",
                     "scene0011_00", "--keyframes", "1", "--batch_size", "2",
                     "--image_resize", "0.1", "--output_dir", str(tmp_path / "out"),
                     "--device", "cpu"]) == 0
    assert "scene0011_00_keyframe_1: EPE3D=" in capsys.readouterr().out
    assert ptr.main(["--dataset", "ScanNet", "--data_root", str(root), "--keyframes", "1",
                     "--batch_size", "2", "--image_resize", "0.1", "--epochs", "1",
                     "--max_steps_per_epoch", "1", "--no_val", "--checkpoint_folder",
                     str(tmp_path / "logs"), "--device", "cpu"]) == 0
    assert "step=1)" in capsys.readouterr().out
