"""PyTorch port vs the JAX package: ``utils/display``, the port's PNG writer
and palette decoder, the evaluate CLI's ``--save_img`` diagnostics and
``apps/warping_objects``.

The display functions run the JAX package's numpy arithmetic: their images
are compared bit for bit.  The PNG files of both packages are read back with
PIL and with the port's decoder: a file of the port's writer holds exactly
the pixels PIL would have written.  The CLIs run on the MovingObjects3D
fixture of ``tests/test_torch_port_mo3d.py`` (128x160, read at 0.25) with
the port's seeded weights carried to flax (``convert_state_dict``).  Their
images go through a float32 solve in each package and then ``* 255``
truncated to ``uint8``: a value the two packages round 1e-6 apart may land
on either side of a level, so those images are held to at most one level
apart and at least 99.9% of their samples equal (on this fixture one sample
of 46,080 in one file differs, by one level); the ground-truth warps of
``warping_objects --gt_pose`` sample the same coordinates in both and are
held the same way.  The printed masked residuals within 1e-4.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.apps import warping_objects as pwo
from deep_prob_feature_track_torch.data import moving_objects as pmo
from deep_prob_feature_track_torch.data.png import read_png, write_png
from deep_prob_feature_track_torch.utils import display as pd
from deep_prob_feature_track_tpu.apps import evaluate as jev
from deep_prob_feature_track_tpu.apps import warping_objects as jwo
from deep_prob_feature_track_tpu.data import moving_objects as jmo
from deep_prob_feature_track_tpu.training import checkpoints as jckpt
from deep_prob_feature_track_tpu.utils import display as jd

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_mo3d import CATEGORIES, write_fixture  # noqa: E402

torch.set_num_threads(2)


# ------------------------------------------------------------------ display


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_normalize_colormap_and_image_to_display(rng):
    x = rng.randn(9, 13).astype(np.float32)
    _same(pd.normalize01(x), jd.normalize01(x))
    _same(pd.normalize01(np.full((3, 4), 2.0)), jd.normalize01(np.full((3, 4), 2.0)))
    y = rng.rand(5, 6) * 1.4 - 0.2
    _same(pd.colormap_jet(y), jd.colormap_jet(y))
    for img in (x, x[None], rng.rand(3, 9, 13) * 1.2, rng.rand(9, 13, 3), rng.rand(9, 13, 1)):
        for cmap in (None, "jet"):
            _same(pd.image_to_display(img, cmap), jd.image_to_display(img, cmap))


def test_mosaics_and_feature_channels(rng):
    images = [rng.rand(8, 10), rng.rand(3, 8, 10), rng.rand(6, 7)]
    for rows in (None, 1, 2):
        _same(pd.create_mosaic(images, cmap=["jet", None, "jet"], rows=rows),
              jd.create_mosaic(images, cmap=["jet", None, "jet"], rows=rows))
    feat = rng.randn(2, 5, 8, 10).astype(np.float32)
    rgb = rng.rand(3, 8, 10).astype(np.float32)
    for args in ((feat,), (feat[0], rgb), (feat, rgb[None], False)):
        _same(pd.visualize_feature_channels(*args), jd.visualize_feature_channels(*args))
    for kw in ({}, {"max_img": 1, "max_channel": 3}, {"step_image": 2, "step_channel": 2}):
        _same(pd.visualize_frames(feat, **kw), jd.visualize_frames(feat, **kw))


def test_flow_colours_and_match_dots(rng):
    flow = rng.randn(2, 9, 11).astype(np.float32)
    _same(pd.flow_to_color(flow), jd.flow_to_color(flow))
    image = rng.rand(3, 40, 64).astype(np.float32)
    matches = rng.uniform(-5, 70, (2, 30))  # some outside the image
    for kw in ({}, {"radius": 3, "color": (0.0, 1.0, 0.0), "alpha": 0.3}):
        _same(pd.visualize_matches_on_image(image, matches, **kw),
              jd.visualize_matches_on_image(image, matches, **kw))


# ----------------------------------------------------------------- PNG files


@pytest.mark.parametrize("shape", [(7, 9, 3), (1, 1, 3), (64, 80, 3)])
def test_png_writer_reads_back_in_pil(tmp_path, rng, shape):
    img = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    pil = Image.open(path)
    assert pil.mode == "RGB"
    _same(np.asarray(pil), img)
    _same(read_png(path), img)
    for bad in (img.astype(np.float32), img[..., 0], np.zeros((4, 5, 4), np.uint8)):
        with pytest.raises(ValueError, match="write_png takes uint8"):
            write_png(path, bad)


def test_save_image_matches_the_jax_file(tmp_path, rng):
    """Clipped, scaled by 255 and truncated, as the JAX ``save_image``
    (through PIL) writes it."""
    img = (rng.rand(12, 17, 3) * 1.3 - 0.15).astype(np.float32)
    pd.save_image(str(tmp_path / "port.png"), img)
    jd.save_image(str(tmp_path / "jax.png"), img)
    _same(np.asarray(Image.open(tmp_path / "port.png")),
          np.asarray(Image.open(tmp_path / "jax.png")))


def test_palette_png_decodes_to_its_indices(tmp_path, rng):
    """An 8-bit palette file: the indices, as PIL reads them."""
    path = str(tmp_path / "palette.png")
    img = Image.frombytes("P", (11, 6), rng.randint(0, 7, (6, 11)).astype(np.uint8).tobytes())
    img.putpalette(list(rng.randint(0, 256, 768)))
    img.save(path)
    assert Image.open(path).mode == "P"
    _same(read_png(path)[..., 0], np.asarray(Image.open(path)))


# --------------------------------------------------------------- the apps


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("mo3d"))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's seeded ``feature`` weights as a ``.pt`` file and, carried
    to flax, as a msgpack file."""
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import checkpoints
    from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict

    folder = tmp_path_factory.mktemp("weights")
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    return (checkpoints.save_variables(str(folder / "w.pt"), port.state_dict()),
            jckpt.save_variables(str(folder / "w.msgpack"), v))


@pytest.fixture
def categories(monkeypatch):
    for mod in (pmo, jmo):
        monkeypatch.setattr(mod, "CATEGORIES", CATEGORIES)


def _close_images(got_path, ref_path):
    """Both files read with PIL, and the port's with its own decoder too:
    at most one level apart, at least 99.9% of the samples equal."""
    got, ref = np.asarray(Image.open(got_path)), np.asarray(Image.open(ref_path))
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    _same(read_png(str(got_path)).reshape(got.shape), got)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (got_path, diff.max(),
                                                            (diff == 0).mean())


def test_evaluate_cli_save_img_matches_jax(tmp_path, root, categories, weights):
    """``--save_img 1``: the first loader's first batch, drawn per level
    (features, sigma, |weighted residual|) and the finest level's matches,
    with the masks in the diagnostics forward (MovingObjects3D)."""
    pt, msgpack = weights
    common = ["--dataset", "MovingObjects3D", "--data_root", root, "--keyframes", "1",
              "--batch_size", "2", "--image_resize", "0.25", "--trajectory", "boat",
              "--save_img", "1"]
    assert jev.main([*common, "--checkpoint", msgpack, "--output_dir",
                     str(tmp_path / "jax")]) == 0
    assert pev.main([*common, "--checkpoint", pt, "--output_dir", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    jvis, pvis = tmp_path / "jax" / "w" / "vis", tmp_path / "port" / "w" / "vis"
    names = sorted(p.relative_to(jvis) for p in jvis.rglob("*.png"))
    assert names == sorted(p.relative_to(pvis) for p in pvis.rglob("*.png"))
    assert len(names) == 13  # feat0, sigma0, residual at 4 levels; matches
    for name in names:
        _close_images(pvis / name, jvis / name)


@pytest.mark.parametrize("mode", ["gt_pose", "tracked"])
def test_warping_objects_matches_jax(tmp_path, root, categories, weights, mode, capsys):
    pt, msgpack = weights
    common = ["--data_root", root, "--object", "boat", "--num_pairs", "3"]
    common += ["--gt_pose"] if mode == "gt_pose" else []
    assert jwo.main([*common, "--checkpoint", msgpack, "--output_dir",
                     str(tmp_path / "jax")]) == 0
    ref = capsys.readouterr().out
    assert pwo.main([*common, "--checkpoint", pt, "--output_dir", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def residuals(text):
        return [float(x) for x in re.findall(r"masked residual ([0-9.]+)", text)]

    assert len(residuals(got)) == 3
    np.testing.assert_allclose(residuals(got), residuals(ref), atol=1e-4, rtol=0)
    for i in range(3):
        name = f"pair_{i:04d}.png"
        _close_images(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_warping_objects_gt_pose_warps_the_object_into_place(tmp_path, root, categories):
    """Under the ground-truth object pose the masked residual is a tenth of
    the one under the identity, at the fixture's full 128x160: the
    object-centric transform moves the object's pixels onto it."""
    from deep_prob_feature_track_torch.data.loader import load_data

    item = load_data("MovingObjects3D", [1], "test", select_traj="boat", root=root,
                     image_resize=1.0)[0]
    T = torch.from_numpy(item["transform"][None])
    gt = pwo.warp_residual_mosaic(item, (T[:, :3, :3], T[:, :3, 3]), str(tmp_path / "gt.png"),
                                  device="cpu")
    eye = pwo.warp_residual_mosaic(item, (torch.eye(3)[None], torch.zeros(1, 3)),
                                   str(tmp_path / "eye.png"), device="cpu")
    assert gt < 0.15 * eye, (gt, eye)
    assert read_png(str(tmp_path / "gt.png")).shape == (2 * 128, 2 * 160, 3)
