"""PyTorch port vs the JAX package: ``geometry/lie.py::matrix_to_quat``,
``apps/traj_eval.py``, ``apps/kf_vo.py`` and ``apps/import_checkpoint.py``.

The VO fixture is a 640x480 TUM-format sequence of 5 frames
(``chip_smoke.write_tum_sequence``, written with PIL) read at
``image_resize`` 0.1 (48x64); the ``feature`` weights are the flax
``PRNGKey(7)`` init carried over by ``from_flax``.  Tolerances:

- ``matrix_to_quat``: 1e-12 in float64, 1e-6 in float32 (the same
  candidate chosen; one float32 rounding of a square root and a division);
- ``traj_eval``'s trajectories, associations, ATE, RPE and JSON line:
  exact (the same numpy code on the same files);
- ``run_vo``'s chained poses: 1e-4 (each B=1 forward agrees within ~1e-5,
  four frames chain); ``--gt_tracker``: exact between the packages, 1e-6
  against the written ground truth (the float32 relative poses);
- the trajectory file read back: 5e-6 (six printed decimals);
- ``import_checkpoint``: every float leaf exact, the imported forward bit
  for bit against the source tracker's, and within 1e-5 of the JAX
  forward on the JAX tool's variables.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from deep_prob_feature_track_torch.apps import import_checkpoint as pic
from deep_prob_feature_track_torch.apps import kf_vo as pvo
from deep_prob_feature_track_torch.apps import traj_eval as pte
from deep_prob_feature_track_torch.apps.serve import example_batch
from deep_prob_feature_track_torch.data.loader import load_data as p_load_data
from deep_prob_feature_track_torch.geometry import lie as tl
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_tpu.apps import import_checkpoint as jic
from deep_prob_feature_track_tpu.apps import kf_vo as jvo
from deep_prob_feature_track_tpu.apps import traj_eval as jte
from deep_prob_feature_track_tpu.data.loader import load_data as j_load_data
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import checkpoints as jck

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
KEYS = ("color0", "color1", "depth0", "depth1", "calib")
RESIZE = 0.1


# ------------------------------------------------------------ matrix_to_quat


def _rotations(rng):
    """Random rotations and the near-degenerate classes: angle near pi
    (trace near -1) about a random axis and about each coordinate axis
    (one diagonal entry dominant), and rotations by a tiny angle."""
    axes = np.concatenate([rng.randn(6, 3), np.eye(3), np.eye(3) + 0.01 * rng.randn(3, 3)])
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([np.full(6, np.pi - 1e-3), np.full(3, np.pi),
                             np.full(3, np.pi - 1e-6)])
    twists = np.concatenate([rng.randn(16, 3), axes * angles[:, None],
                             rng.randn(4, 3) * 1e-7])
    return np.asarray(jl.exp_so3(jnp.asarray(twists)))


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_matrix_to_quat_matches_jax(rng, dtype, atol):
    R = _rotations(rng).astype(dtype)
    got = tl.matrix_to_quat(torch.from_numpy(R)).numpy()
    ref = np.asarray(jl.matrix_to_quat(jnp.asarray(R)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    # a unit quaternion of the same rotation
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=10 * atol)
    back = Rotation.from_quat(got.astype(np.float64)).as_matrix()  # [x, y, z, w]
    np.testing.assert_allclose(back, R, atol=1e-5 if dtype == np.float32 else 1e-9)


# ----------------------------------------------------------------- traj_eval


def _trajectory(rng, n):
    poses = [np.eye(4)]
    for _ in range(n - 1):
        d = np.eye(4)
        d[:3, :3] = np.asarray(jl.exp_so3(jnp.asarray(0.03 * rng.randn(3))))
        d[:3, 3] = 0.05 * rng.randn(3)
        poses.append(poses[-1] @ d)
    return np.stack(poses)


@pytest.fixture
def trajectories(tmp_path, rng):
    """A ground truth of 20 poses and an estimate off by a rigid offset
    and per-frame noise, with timestamps jittered by up to 8 ms and one
    estimate dropped."""
    gt = _trajectory(rng, 20)
    est = np.einsum("ij,njk->nik", jl_T(0.2, [1.0, -2.0, 0.5]), gt)
    est[:, :3, 3] += 0.01 * rng.randn(20, 3)
    stamps = 1.0 + 0.1 * np.arange(20)
    jitter = stamps + rng.uniform(-0.008, 0.008, 20)
    gt_file, est_file = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    pvo.write_tum_trajectory(gt_file, gt, timestamps=stamps)
    keep = np.arange(20) != 7
    pvo.write_tum_trajectory(est_file, est[keep], timestamps=jitter[keep])
    return est_file, gt_file


def jl_T(angle, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(jl.exp_so3(jnp.asarray([0.0, 0.0, angle])))
    T[:3, 3] = t
    return T


def test_traj_eval_matches_jax(trajectories, capsys):
    est_file, gt_file = trajectories
    se, te = pte.load_tum_trajectory(est_file)
    sg, tg = pte.load_tum_trajectory(gt_file)
    for path, (s, T) in ((est_file, (se, te)), (gt_file, (sg, tg))):
        s_j, T_j = jte.load_tum_trajectory(path)
        np.testing.assert_array_equal(s, s_j)
        np.testing.assert_array_equal(T, T_j)
    pairs = pte.associate(se, sg, max_dt=0.02)
    assert pairs == jte.associate(se, sg, max_dt=0.02) and len(pairs) == 19
    e, g = te[[i for i, _ in pairs]], tg[[j for _, j in pairs]]
    assert pte.ate(e, g) == jte.ate(e, g) and pte.ate(e, g) > 1e-3
    for delta in (1, 3):
        assert pte.rpe(e, g, delta) == jte.rpe(e, g, delta)
    lines = []
    for mod in (pte, jte):
        assert mod.main(["--est", est_file, "--gt", gt_file, "--delta", "2"]) == 0
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert lines[0] == lines[1] and lines[0]["pairs"] == 19
    with pytest.raises(SystemExit, match="associated poses"):
        pte.main(["--est", est_file, "--gt", gt_file, "--max_dt", "1e-9"])


def test_ate_rmse_matches_jax(rng):
    est, gt = rng.randn(20, 3), rng.randn(20, 3)
    assert pvo.ate_rmse(est, gt) == jvo.ate_rmse(est, gt)
    assert pvo.ate_rmse(gt @ jl_T(0.3, 0)[:3, :3].T + 1.0, gt) < 1e-9


# ---------------------------------------------------------------------- kf_vo


def _save_pil(path, array):
    Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path) \
        if array.dtype == np.uint16 else Image.fromarray(array).save(path)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    seq = str(tmp_path_factory.mktemp("tum") / "seq")
    gt = write_tum_sequence(seq, n=5, save=_save_pil)
    return seq, np.stack(gt)


def _datasets(seq):
    return (p_load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=RESIZE, root=""),
            j_load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=RESIZE, root=""))


@pytest.fixture(scope="module")
def forwards(sequence):
    """The JAX and the port B=1 ``feature`` forwards on the same weights."""
    _, jds = _datasets(sequence[0])
    item = jds[0]
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(item[k][None]) for k in KEYS]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    fwd = jax.jit(lambda *a: net.apply(v, *a, train=False))
    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    return fwd, port


@pytest.mark.parametrize("vo_type", ["keyframe", "incremental"])
def test_run_vo_matches_jax(sequence, forwards, vo_type):
    pds, jds = _datasets(sequence[0])
    fwd, port = forwards
    got, got_gt = pvo.run_vo(pds, port, vo_type=vo_type, device="cpu")
    ref, ref_gt = jvo.run_vo(jds, fwd, vo_type=vo_type)
    assert got.shape == ref.shape == (5, 4, 4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_gt, ref_gt)
    assert np.abs(got - np.eye(4)).max() > 1e-3


def test_gt_tracker_reproduces_the_ground_truth(sequence, tmp_path):
    seq, gt = sequence
    pds, jds = _datasets(seq)
    for vo_type in ("keyframe", "incremental"):
        got, got_gt = pvo.run_vo(pds, None, vo_type=vo_type, use_gt=True,
                                 kf_switch_dist=0.02, device="cpu")
        ref, _ = jvo.run_vo(jds, None, vo_type=vo_type, use_gt=True, kf_switch_dist=0.02)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, got_gt)
        np.testing.assert_allclose(got, gt, atol=1e-6, rtol=0)
    # the CLI with --gt_tracker, its file against the written ground truth
    out = str(tmp_path / "gt_vo.txt")
    assert pvo.main(["--data_root", "", "--trajectory", seq, "--gt_tracker", "--image_resize",
                     str(RESIZE), "--output", out, "--device", "cpu"]) == 0
    _, T = pte.load_tum_trajectory(out)
    np.testing.assert_allclose(T, gt, atol=5e-6, rtol=0)


def _switches(out):
    return [int(line.split()[2].rstrip(":")) for line in out.splitlines()
            if "new keyframe" in line]


def test_keyframe_switch_at_the_same_frames(sequence, forwards, capsys):
    """With ``kf_switch_dist`` below the estimated motion of two frames
    (~2.9 cm) and above that of one (~1.5 cm), both packages switch at
    the same frames."""
    pds, jds = _datasets(sequence[0])
    fwd, port = forwards
    pvo.run_vo(pds, port, kf_switch_dist=0.022, verbose=True, device="cpu")
    got = _switches(capsys.readouterr().out)
    jvo.run_vo(jds, fwd, kf_switch_dist=0.022, verbose=True)
    ref = _switches(capsys.readouterr().out)
    assert got == ref and len(got) >= 1, (got, ref)


def test_trajectory_file_round_trip(sequence, tmp_path):
    _, gt = sequence
    path = str(tmp_path / "vo" / "traj.txt")
    stamps = 1.0 + 0.1 * np.arange(len(gt))
    pvo.write_tum_trajectory(path, gt, timestamps=stamps)
    for load in (pte.load_tum_trajectory, jte.load_tum_trajectory):
        s, T = load(path)
        np.testing.assert_allclose(s, stamps, atol=1e-9)
        np.testing.assert_allclose(T, gt, atol=5e-6, rtol=0)
    ref = str(tmp_path / "jax.txt")
    jvo.write_tum_trajectory(ref, gt, timestamps=stamps)
    assert open(path).read() == open(ref).read()


# --------------------------------------------------------- import_checkpoint


def _reference_file(path, preset, extra=None):
    """A checkpoint in the original implementation's format, from a seeded
    tracker of ``preset``: ``{"state_dict": ...}`` with DataParallel's
    ``module.`` prefixes, nonzero ``num_batches_tracked`` and each learned
    M-estimator and damping net registered again under every level's
    ``tr_update{i}``."""
    net = LeastSquareTracking(get_preset(preset)).reset_parameters(3)
    state = {}
    for k, v in net.state_dict().items():
        state[k] = torch.tensor(7) if k.endswith("num_batches_tracked") else v.clone()
        for prefix, alias in (("mEst_func.", "mEstimator."), ("solver_func.", "directSolver.")):
            if k.startswith(prefix):
                for i in range(4):
                    state[f"tr_update{i}.{alias}{k[len(prefix):]}"] = v.clone()
    state.update(extra or {})
    torch.save({"epoch": 29, "state_dict": {f"module.{k}": v for k, v in state.items()}}, path)
    return net


@pytest.fixture
def jitted_jax_init(monkeypatch):
    """The JAX tool initializes its tracker op by op (~30 s here); jitted,
    the init draws the same values sooner, and the checkpoint overwrites
    every one of them."""
    init = JaxTracker.init

    def jitted(self, rng, *args, **kwargs):
        return jax.jit(lambda r, *a: init(self, r, *a, **kwargs))(rng, *args)

    monkeypatch.setattr(JaxTracker, "init", jitted)


@pytest.mark.parametrize("preset", ["feature", "DeepIC"])
def test_import_checkpoint_matches_jax(tmp_path, preset, jitted_jax_init):
    src = str(tmp_path / "ref.pth.tar")
    source = _reference_file(src, preset)
    out = str(tmp_path / "port.pt")
    assert pic.main(["--torch_checkpoint", src, "--preset", preset, "--output", out,
                     "--strict"]) == 0
    got = checkpoints.restore_variables(out)
    assert jic.main(["--torch_checkpoint", src, "--preset", preset, "--output",
                     str(tmp_path / "jax.msgpack"), "--strict"]) == 0
    variables = jck.restore_variables(str(tmp_path / "jax.msgpack"))
    ref = from_flax(variables)
    assert set(got) == set(ref) == set(source.state_dict())
    for key, value in ref.items():
        if key.endswith("num_batches_tracked"):
            assert got[key].item() == 7
        else:
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
            torch.testing.assert_close(got[key], source.state_dict()[key], rtol=0, atol=0)
    # the imported tracker's forward is the source tracker's, bit for bit
    batch = example_batch(2, 32, 40, seed=4, device="cpu")
    imported = LeastSquareTracking(get_preset(preset))
    imported.load_state_dict(got, strict=True)
    with torch.inference_mode():
        R, t = imported(*batch)
        R_s, t_s = source(*batch)
    torch.testing.assert_close(R, R_s, rtol=0, atol=0)
    torch.testing.assert_close(t, t_s, rtol=0, atol=0)
    if preset == "feature":
        net = JaxTracker(cfg=jp.get_preset(preset))
        R_j, t_j = jax.jit(lambda *a: net.apply(variables, *a, train=False))(
            *(jnp.asarray(x.numpy()) for x in batch))
        np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-5, rtol=0)


def test_import_checkpoint_reports_unmapped_keys(tmp_path, capsys):
    """An extra key fails ``--strict`` in both tools; without it, the port's
    tool reports it.  A per-level M-estimator (``no_weight_sharing``) is
    never loaded into the shared one: ``map_state_dict`` reports it against
    a tracker that shares it, and the CLI, seeing a module of level 1, builds
    the preset with a module a level (the bare name is level 0)."""
    src = str(tmp_path / "ref.pth.tar")
    _reference_file(src, "feature", {"bogus.weight": torch.zeros(3)})
    for tool in (pic, jic):
        with pytest.raises(SystemExit, match="unmapped"):
            tool.main(["--torch_checkpoint", src, "--output", str(tmp_path / "x"),
                       "--strict"])
    assert pic.main(["--torch_checkpoint", src, "--output", str(tmp_path / "x.pt")]) == 0
    assert "bogus.weight" in capsys.readouterr().out
    src = str(tmp_path / "levels.pth.tar")
    level1 = {"mEst_func1.net.0.0.weight": torch.zeros(16, 4, 3, 3)}
    source = _reference_file(src, "DeepIC", level1)
    _, unmapped = pic.map_state_dict({**source.state_dict(), **level1}, source.state_dict())
    assert unmapped == {"mEst_func1.net.0.0.weight": "no such key in the preset's tracker"}
    assert pic.main(["--torch_checkpoint", src, "--preset", "DeepIC", "--strict",
                     "--output", str(tmp_path / "y.pt")]) == 0
    assert "unmapped" not in capsys.readouterr().out
    got = checkpoints.restore_variables(str(tmp_path / "y.pt"))
    assert "mEst_func.net.0.0.weight" not in got
    torch.testing.assert_close(got["mEst_func0.net.0.0.weight"],
                               source.state_dict()["mEst_func.net.0.0.weight"])
    assert torch.equal(got["mEst_func1.net.0.0.weight"], level1["mEst_func1.net.0.0.weight"])
    # an alias without its primary loads into the shared module
    state = {k: v for k, v in source.state_dict().items() if not k.startswith("solver_func.")}
    state.update({f"tr_update{i}.directSolver.{k[len('solver_func.'):]}": v
                  for k, v in source.state_dict().items() if k.startswith("solver_func.")
                  for i in range(4)})
    mapped, unmapped = pic.map_state_dict(state, source.state_dict())
    assert not unmapped and set(mapped) == set(source.state_dict())
