"""PyTorch port vs the JAX package: ``apps/ba_refine.py``.  That the back
end's helpers take the card unless asked is held in
``tests/test_torch_port_ba_refine_helpers.py``.

The fixture is a 640x480 TUM-format sequence of 5 frames
(``chip_smoke.write_tum_sequence``) read at ``image_resize`` 0.1 (48x64);
the ``feature`` weights are the port's seeded init, carried to the JAX
package by its ``convert_state_dict``.  The JAX package runs with x64 off,
as it runs on its device, so that both CLIs keep the pose graph and the
dense window in float32 (every JAX call of the file: a program traced
with x64 on and called again under ``jax.enable_x64(False)`` moved the
trajectory by 1.5e-5).

Tolerances:

- ``window_pairs``: equal;
- ``track_pairs``: R and t within 1e-5, each information matrix within
  1e-4 of its largest entry (level 0's float32 sums over 3,072 pixels);
- the trajectory files of both CLIs without ``--dense``: within 3e-6,
  three units of the file's sixth decimal (two roundings of float32 poses
  that agree within ~1e-6);
- with ``--dense``: within 5e-5.  Given the same window and start poses the
  two packages' dense stages agree within 1.6e-7, and the port's float32
  stage lies 1.6e-7 from its float64 one; but the CLIs start it from
  their own pose graphs, 1e-6 apart, which flips the in-view or
  occlusion test of a few of the 24x32 level's pixels: the first dense
  cost moves by 1e-4 relative (241.6624 against 241.6422) and the poses by
  up to 1.5e-5;
- the printed ATE-RMSE (two decimals, cm) within 0.01 cm.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps import ba_refine as pba
from deep_prob_feature_track_torch.data.loader import load_data as p_load_data
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_tpu.apps import ba_refine as jba
from deep_prob_feature_track_tpu.data.loader import load_data as j_load_data
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import checkpoints as jck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
RESIZE = 0.1


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    seq = str(tmp_path_factory.mktemp("tum") / "seq")
    write_tum_sequence(seq, n=5)
    return seq


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's seeded ``feature`` weights as a ``.pt`` and a flax
    msgpack file."""
    d = tmp_path_factory.mktemp("w")
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    jck.save_variables(str(d / "w.msgpack"), v)
    checkpoints.save_variables(str(d / "w.pt"), port.state_dict())
    return port, v, str(d / "w.pt"), str(d / "w.msgpack")


@pytest.mark.parametrize("n,window", [(1, 3), (5, 1), (5, 2), (6, 3), (4, 9)])
def test_window_pairs_match_jax(n, window):
    assert pba.window_pairs(n, window) == jba.window_pairs(n, window)


def test_track_pairs_matches_jax(sequence, weights):
    """7 pairs in batches of 4: the second chunk is padded with a copy of
    its last pair, in both packages."""
    seeded, v, _, _ = weights
    port = LeastSquareTracking(dataclasses.replace(get_preset("feature"), uncer_prop=True))
    port.load_state_dict(seeded.state_dict(), strict=True)
    net = JaxTracker(cfg=dataclasses.replace(jp.get_preset("feature"), uncer_prop=True))

    @jax.jit
    def jfwd(*a):
        (R, t), JtWJ = net.apply(v, *a, train=False)
        return R, t, JtWJ

    def pfwd(*a):
        (R, t), JtWJ = port(*a)
        return R, t, JtWJ

    pairs = pba.window_pairs(5, 2)
    assert len(pairs) == 7
    pds = p_load_data("TUM_RGBD", [1], "test", select_traj=sequence, image_resize=RESIZE,
                      root="")
    jds = j_load_data("TUM_RGBD", [1], "test", select_traj=sequence, image_resize=RESIZE,
                      root="")
    got_meas, got_infos = pba.track_pairs(pds, pairs, pfwd, batch_size=4, device="cpu")
    with jax.enable_x64(False):
        ref_meas, ref_infos = jba.track_pairs(jds, pairs, jfwd, batch_size=4)
    assert len(got_meas) == len(got_infos) == 7
    for (gR, gt), (rR, rt) in zip(got_meas, ref_meas):
        np.testing.assert_allclose(gR, rR, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gt, rt, atol=1e-5, rtol=0)
    for g, r in zip(got_infos, ref_infos):
        assert g.shape == (6, 6)
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max(), rtol=0)
    # the padded chunk's copy entered the batch: the last pair equals a
    # forward of the chunk padded by hand
    items = [pds.pair_frames(*p) for p in pairs[4:] + [pairs[-1]]]
    batch = [torch.from_numpy(np.stack([it[k] for it in items])) for k in pba.KEYS]
    with torch.inference_mode():
        R, t, JtWJ = pfwd(*batch)
    np.testing.assert_array_equal(got_meas[-1][1], t[2].numpy())
    np.testing.assert_array_equal(got_infos[-1], JtWJ[2].numpy())


def _stdout_lines(capsys, prefix="[ba_refine] ATE"):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(prefix)]


def _ate(lines):
    """The odometry and refined ATE-RMSE (cm) of the printed line."""
    (line,) = lines
    return [float(w) for w in line.split() if w.replace(".", "").isdigit()]


@pytest.mark.parametrize("dense", [False, True])
def test_ba_refine_cli_matches_jax(tmp_path, sequence, weights, capsys, dense):
    _, _, pt, msgpack = weights
    common = ["--data_root", "", "--trajectory", sequence, "--image_resize", str(RESIZE),
              "--window", "2", "--batch_size", "4", "--iterations", "6"]
    if dense:
        common += ["--dense", "--dense_iterations", "3"]
    with jax.enable_x64(False):
        assert jba.main([*common, "--checkpoint", msgpack,
                         "--output", str(tmp_path / "jax.txt")]) == 0
    ref_ate = _stdout_lines(capsys)
    assert pba.main([*common, "--checkpoint", pt, "--output", str(tmp_path / "port.txt"),
                     "--device", "cpu"]) == 0
    got_ate = _stdout_lines(capsys)
    ref, got = (np.loadtxt(tmp_path / f) for f in ("jax.txt", "port.txt"))
    assert got.shape == ref.shape == (5, 8)
    np.testing.assert_array_equal(got[:, 0], np.arange(5.0))
    np.testing.assert_allclose(got, ref, atol=5e-5 if dense else 3e-6, rtol=0)
    np.testing.assert_allclose(_ate(got_ate), _ate(ref_ate), atol=0.0101, rtol=0)
    assert np.abs(got[:, 1:4]).max() > 5e-3  # the camera moved


def test_ba_refine_cli_on_a_dataset_without_ground_truth(tmp_path, sequence, capsys):
    """On VaryLighting (no ground truth) the CLI writes the trajectory and
    prints no ATE."""
    scene = tmp_path / "vl" / "scene0"
    for sub in ("rgb", "depth"):
        os.makedirs(scene / sub)
        for name in sorted(os.listdir(os.path.join(sequence, sub)))[:3]:
            os.symlink(os.path.join(sequence, sub, name), scene / sub / name)
    assert pba.main(["--dataset", "VaryLighting", "--data_root", str(tmp_path / "vl"),
                     "--trajectory", "scene0", "--image_resize", str(RESIZE), "--window", "2",
                     "--output", str(tmp_path / "vl.txt"), "--device", "cpu"]) == 0
    assert _stdout_lines(capsys) == []
    assert np.loadtxt(tmp_path / "vl.txt").shape == (3, 8)


def test_sharded_cli_on_one_rank_writes_the_same_trajectory(tmp_path, sequence, capsys):
    """``--sharded`` on a mesh of one rank (no ``torchrun`` environment)
    writes the unsharded CLI's trajectory bit for bit."""
    from deep_prob_feature_track_torch.parallel import mesh as pmesh

    common = ["--data_root", "", "--trajectory", sequence, "--image_resize", str(RESIZE),
              "--window", "2", "--iterations", "3", "--max_frames", "4", "--device", "cpu"]
    assert pba.main([*common, "--output", str(tmp_path / "one.txt")]) == 0
    assert pba.main([*common, "--sharded", "--output", str(tmp_path / "sharded.txt")]) == 0
    assert not pmesh.dist.is_initialized()  # the CLI tore its group down
    assert (tmp_path / "one.txt").read_bytes() == (tmp_path / "sharded.txt").read_bytes()
    assert len(_stdout_lines(capsys, "[ba_refine] cost")) == 2
