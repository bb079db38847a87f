"""PyTorch port vs the JAX package: MovingObjects3D, the masked evaluation
loop and the evaluate CLI with ``--dataset MovingObjects3D``.

The fixture is ``chip_smoke.write_mo3d_dataset``'s scene (a textured
square turning and moving in front of a textured wall, a moving camera),
written with PIL: colour, 16-bit depth (mm) and 8-bit masks, at 128x160 and
at the odd size 97x131 (``mask="P"``: palette masks, read as PIL reads
their indices), with both packages' ``CATEGORIES`` patched to a few
sequences.  Tolerances:

- dataset items and ``BatchLoader`` batches: bit for bit (colour, depth,
  masks, ``transform``, ``calib``, names; the PIL-rule nearest resize they
  take is held to PIL in ``tests/test_torch_port_mo3d_resize.py``);
- ``evaluate_two_view`` and the evaluate CLI, with the port's seeded
  weights carried to flax (``convert_state_dict``): per-frame R and t atol
  1e-5, EPE3D and translation error rtol 1e-5, the angle error within the
  ``arccos`` bound of ``tests/test_torch_port_eval.py``; the summary CSV's
  rows and columns as the JAX CLI's, its numbers rtol 1e-4; the
  ``--tracker ICP`` baseline within 1e-4, at keyframe gap 1 on the boat
  (one batch of 4), against the JAX CLI run op by op (``jax.disable_jit``):
  at the identity start the jitted JAX program flips in-view tests that the
  op-by-op one and the port agree on, and lands 0.38 m away on this scene.
  At gap 2, float32 ICP on the planar wall and square is chaotic (each
  package's float32 poses 5e-4-1.6e-3 from its float64 ones, the two float64
  programs within 6e-13; ``tests/test_torch_port_baselines.py`` holds the
  baselines' math in float64).
"""

import csv
import os
import pickle
import random
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch import evaluation as pe
from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.data import moving_objects as pmo
from deep_prob_feature_track_torch.data import pipeline as pp
from deep_prob_feature_track_torch.data.loader import load_data
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_tpu import evaluation as je
from deep_prob_feature_track_tpu.apps import evaluate as jev
from deep_prob_feature_track_tpu.data import moving_objects as jmo
from deep_prob_feature_track_tpu.data import pipeline as jpp
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import checkpoints as jckpt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import write_mo3d_dataset  # noqa: E402
from test_torch_port_eval import EPS32, _angle_bound  # noqa: E402

torch.set_num_threads(2)

SEQUENCES = {"aeroplane": 2, "bus": 1, "boat": 2, "motorbike": 1}
CATEGORIES = {"train": {"aeroplane": (0, 2), "bus": (0, 1)},
              "validation": {"aeroplane": (1, 2)},
              "test": {"boat": (0, 2), "motorbike": (0, 1)}}


def pil_saver(mask_mode="L"):
    """Save an image with PIL: 16-bit depth as I;16, masks as 8-bit gray or
    as a palette file."""
    def save(path, array):
        if array.dtype == np.uint16:
            Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path)
        elif array.ndim == 2 and "mask" in os.path.basename(path) and mask_mode == "P":
            img = Image.fromarray(array, mode="L").convert("P")
            img.putpalette([0, 0, 0, 255, 255, 255] + [0] * 762)
            img.save(path)
        else:
            Image.fromarray(array).save(path)
    return save


def write_fixture(root, h=128, w=160, mask_mode="L"):
    write_mo3d_dataset(str(root), h, w, categories=SEQUENCES, test_visible=3,
                       save=pil_saver(mask_mode))
    return str(root)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("mo3d"))


@pytest.fixture(scope="module")
def odd_root(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("mo3d_odd"), 97, 131, mask_mode="P")


@pytest.fixture
def categories(monkeypatch):
    for mod in (pmo, jmo):
        monkeypatch.setattr(mod, "CATEGORIES", CATEGORIES)


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


# ---------------------------------------------------------------- items


@pytest.mark.parametrize("scale", [0.5, 0.25])
@pytest.mark.parametrize("fixture", ["root", "odd_root"])
@pytest.mark.parametrize("category,keyframes", [("train", [1, 2, 4]), ("test", [2])])
def test_items_match_jax_bitwise(request, categories, fixture, scale, category, keyframes):
    data = request.getfixturevalue(fixture)
    got = pmo.MovingObjects3D(data, category, keyframes, image_resize=scale)
    ref = jmo.MovingObjects3D(data, category, keyframes, image_resize=scale)
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        random.seed(i)
        a = got[i]
        random.seed(i)
        _equal_items(a, ref[i])
    assert a["obj_mask0"].dtype == bool and 0 < a["obj_mask0"].mean() < 1


def test_palette_masks_decode_to_their_indices(odd_root):
    path = os.path.join(odd_root, "clip", "mask_0000.png")
    assert Image.open(path).mode == "P"
    from deep_prob_feature_track_torch.data.png import read_png

    np.testing.assert_array_equal(read_png(path)[..., 0], np.asarray(Image.open(path)))


def test_load_data_and_batch_loader_match_jax(root, categories):
    """The keyframe gaps come from the global ``random`` in item order: a
    loader's batches are the JAX loader's, bit for bit."""
    from deep_prob_feature_track_tpu.data.loader import load_data as jload

    batches = []
    for load, loader in ((load_data, pp.BatchLoader), (jload, jpp.BatchLoader)):
        random.seed(3)
        data = load("MovingObjects3D", [1, 2, 4], "train", image_resize=0.25, root=root,
                    augment_seed=1)
        batches.append(list(loader(data, 3, shuffle=True, seed=1, drop_last=True)))
    assert len(batches[0]) == len(batches[1]) == 2
    for a, b in zip(*batches):
        _equal_items(a, b)


def test_to_device_carries_the_bool_masks(root, categories):
    batch = next(iter(pp.BatchLoader(pmo.MovingObjects3D(root, "test", [1], image_resize=0.25),
                                     2, prefetch=0)))
    dev = pp.to_device(batch, "cpu")
    assert dev["obj_mask0"].dtype == torch.bool
    np.testing.assert_array_equal(dev["obj_mask1"].numpy(), batch["obj_mask1"])


# ------------------------------------------------------- evaluate_two_view


@pytest.fixture(scope="module")
def weights():
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    return port, v


def _close_results(got, ref, pose_atol=1e-5):
    assert got["names"] == ref["names"]
    for name in ("R_est", "t_est"):
        np.testing.assert_allclose(got[name], ref[name], atol=pose_atol, rtol=0, err_msg=name)
    for name in ("epes", "translation_error"):
        np.testing.assert_allclose(got[name], ref[name], rtol=max(1e-5, pose_atol), atol=0,
                                   err_msg=name)
    trace_err = 4 * EPS32 + 3 * np.abs(got["R_est"] - ref["R_est"]).max()
    gap = np.abs(got["angular_error"] - ref["angular_error"])
    assert (gap <= _angle_bound(ref["angular_error"], trace_err)).all(), gap


@pytest.mark.parametrize("obj_only", [False, True])
def test_evaluate_two_view_with_masks_matches_jax(root, categories, weights, obj_only):
    """``has_mask``: the EPE3D counts the frame-0 object's pixels alone;
    ``obj_only``: the masks also reach the forward."""
    port, v = weights
    net = JaxTracker(cfg=jp.get_preset("feature"))
    fwd = jax.jit(lambda *a, obj_mask0=None, obj_mask1=None: net.apply(
        v, *a, obj_mask0=obj_mask0, obj_mask1=obj_mask1, train=False))
    loaders = [mod.create_eval_loaders("MovingObjects3D", "test", [1], 2, trajectory="boat",
                                       image_resize=0.25, root=root) for mod in (je, pe)]
    (key,) = loaders[0]
    ref = je.evaluate_two_view(loaders[0][key], fwd, has_mask=True, obj_only=obj_only)
    got = pe.evaluate_two_view(loaders[1][key], port, "cpu", has_mask=True, obj_only=obj_only)
    assert len(got["names"]) == 4
    _close_results(got, ref)
    plain = pe.evaluate_two_view(loaders[1][key], port, "cpu")
    assert np.abs(plain["epes"] - got["epes"]).max() > 1e-6  # the masked EPE3D
    moved = np.abs(plain["t_est"] - got["t_est"]).max()
    assert moved > 1e-5 if obj_only else moved == 0.0


# ------------------------------------------------------------- the CLI


def _rows(path):
    with open(path) as f:
        return {r[0]: r[1:] for r in csv.reader(f)}


def _cli_pair(tmp_path, root, weights, *flags):
    """Run the JAX and the port evaluate CLIs on the fixture with the same
    weights (keyframes 1 and 2, B=2, unless ``flags`` say otherwise);
    return their output directories."""
    port, v = weights
    jckpt.save_variables(str(tmp_path / "w.msgpack"), v)
    checkpoints.save_variables(str(tmp_path / "w.pt"), port.state_dict())
    common = ["--dataset", "MovingObjects3D", "--data_root", root, "--keyframes", "1,2",
              "--batch_size", "2", "--image_resize", "0.25", *flags]
    tracker = next((flags[i + 1] for i, f in enumerate(flags) if f == "--tracker"), None)
    # a baseline starts at the identity, where the jitted JAX program's fused
    # projection flips in-view tests that its op-by-op program and the port
    # agree on (the watch list): hold it against the op-by-op program
    with jax.disable_jit(tracker is not None):
        assert jev.main([*common, "--checkpoint", str(tmp_path / "w.msgpack"),
                         "--output_dir", str(tmp_path / "jax")]) == 0
    assert pev.main([*common, "--checkpoint", str(tmp_path / "w.pt"), "--output_dir",
                     str(tmp_path / "port"), "--device", "cpu"]) == 0
    name = f"nolearning_{tracker}" if tracker else "w"
    return tmp_path / "jax" / name, tmp_path / "port" / name


@pytest.mark.parametrize("tracker", ["learning_based", "ICP"])
def test_evaluate_cli_obj_only_matches_jax(tmp_path, root, categories, weights, tracker):
    flags, keys = ["--obj_only"], ("boat_keyframe_1", "motorbike_keyframe_2")
    if tracker != "learning_based":  # one batch: the JAX baseline runs op by op
        flags += ["--tracker", tracker, "--trajectory", "boat", "--keyframes", "1",
                  "--batch_size", "4"]
        keys = ("boat_keyframe_1",)
    jdir, pdir = _cli_pair(tmp_path, root, weights, *flags)
    ref, got = _rows(jdir / "summary.csv"), _rows(pdir / "summary.csv")
    # the header, a row a loader (object x gap), two mean rows a gap
    assert list(got) == list(ref) and len(ref) == (9 if tracker == "learning_based" else 4)
    tol = 1e-5 if tracker == "learning_based" else 1e-4
    for name, row in ref.items():
        for a, b in zip(got[name], row):
            try:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-4, err_msg=name)
            except ValueError:
                assert a == b, name
    for key in keys:
        with open(jdir / f"{key}.pkl", "rb") as f:
            want = pickle.load(f)
        with open(pdir / f"{key}.pkl", "rb") as f:
            have = pickle.load(f)
        _close_results(have, want, tol)

