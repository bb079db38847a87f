"""PyTorch port vs the JAX package: the non-learned baselines of
``apps/baselines.py`` and the evaluate CLI's ``--tracker``.

The scenes are those of ``tests/test_baselines.py``: the textured plane of
``tests/test_trust_region.py::make_pair`` under a known motion (64x80) for
the photometric and hybrid trackers, and the curved depth surface moved
2 cm toward the camera for the ICP ones, here at B=2.  Each tracker's
``batch_track`` gets the same float32 arrays in both packages.
Tolerances:

- R and t of every tracker: 1e-5 (float32 rounding through 40-94 chained
  Gauss-Newton solves, measured below 4e-7).  ``Point2Point`` is held so
  against the JAX program run op by op (``jax.disable_jit``); its jitted
  program flips the in-view mask (``0 < u < W-1``, ``0 < v < H-1``) of 16
  of the 160 level-2 pixels at the identity start, where the projection
  lands on the frame's edges and XLA's fused division rounds otherwise,
  so against it the envelope is 2e-3 (measured 1.4e-4 on R, 7.6e-4 on t);
- the convergence thresholds of ``tests/test_baselines.py``, unchanged;
- the divergence guard: exact, against the JAX guard too (a NaN pose
  passes through both);
- the evaluate CLI against the JAX CLI on a written 5-frame sequence at
  48x64: with ``RGBD`` the per-frame poses within 1e-5 (measured 1.2e-6),
  EPE3D and the translation error of ``summary.csv`` within 1e-4
  relative; with ``ICP`` the poses within 5e-3 (measured 1.0e-3) and those
  columns within 1e-2 relative (measured 1.1e-3): on this planar scene the
  point-to-plane system barely sees in-plane motion, and float32 rounding
  moves either package's poses by up to 1e-3 (the port's float32 against
  its float64 poses), while in float64 the two packages agree within 1e-9
  on the same batch.  The angle error, from ``arccos`` near 1, is held to
  the bound the R difference gives it (as in ``test_torch_port_eval.py``).
"""

import csv
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch import evaluation as pe
from deep_prob_feature_track_torch.apps import baselines as pb
from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.solvers import jacobians as tj
from deep_prob_feature_track_tpu.apps import baselines as jb
from deep_prob_feature_track_tpu.apps import evaluate as jev
from tests.test_trust_region import make_pair

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
P2P_JIT_ENVELOPE = 2e-3


def _jax_tracker(name):
    """The JAX CLI's table of ``--tracker`` baselines."""
    return {
        "ICP": lambda: jb.ICPOdometry(),
        "Point2Point": lambda: jb.ICPOdometry(mode="Point2Point"),
        "Iter_Point2Plane": lambda: jb.ICPOdometry(mode="Iter_Point2Plane"),
        "RGBD": lambda: jb.RGBDOdometry(term="hybrid"),
        "ColorICP": lambda: jb.RGBDOdometry(term="color"),
        "Iter_ColorICP": lambda: jb.RGBDOdometry(term="color",
                                                 schedule=((2, 50), (1, 30), (0, 14))),
    }[name]()


def _photometric_scene(B=2, H=64, W=80):
    K, f0, f1, depth0, depth1, pose_gt = make_pair(np.random.RandomState(0), B=B, H=H, W=W)
    c0 = np.repeat(np.clip((np.asarray(f0) + 2) / 4, 0, 1), 3, axis=1)
    c1 = np.repeat(np.clip((np.asarray(f1) + 2) / 4, 0, 1), 3, axis=1)
    arrays = [c0, np.asarray(depth0), c1, np.asarray(depth1), np.asarray(K)]
    return [a.astype(np.float32) for a in arrays], [np.asarray(p) for p in pose_gt]


def _depth_scene(B, H, W, tz=0.02, fx=26.0):
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = (2.0 + 0.2 * np.sin(xx / 6.0) + 0.15 * np.cos(yy / 5.0)).astype(np.float32)
    d0 = np.tile(base[None, None], (B, 1, 1, 1))
    K = np.tile([[fx, fx, (W - 1) / 2, (H - 1) / 2]], (B, 1)).astype(np.float32)
    c = np.zeros((B, 3, H, W), np.float32)
    return [c, d0, c, d0 - tz, K]


def _scene(name):
    if name in ("RGBD", "ColorICP", "Iter_ColorICP"):
        return _photometric_scene()[0]
    return _depth_scene(2, 32, 40)


def _port(tracker, arrays):
    R, t = tracker.batch_track(*(torch.from_numpy(a) for a in arrays))
    return R.numpy(), t.numpy()


@pytest.mark.parametrize("name", pb.TRACKERS)
def test_batch_track_matches_jax(name):
    arrays = _scene(name)
    R, t = _port(pb.make_baseline(name), arrays)
    assert np.isfinite(t).all() and np.abs(t).max() > 1e-3
    atol = ATOL
    if name == "Point2Point":  # see the module docstring
        with jax.disable_jit():
            R_e, t_e = _jax_tracker(name).batch_track(*arrays)
        np.testing.assert_allclose(R, R_e, atol=ATOL, rtol=0)
        np.testing.assert_allclose(t, t_e, atol=ATOL, rtol=0)
        atol = P2P_JIT_ENVELOPE
    R_j, t_j = _jax_tracker(name).batch_track(*arrays)
    np.testing.assert_allclose(R, R_j, atol=atol, rtol=0)
    np.testing.assert_allclose(t, t_j, atol=atol, rtol=0)


def _error(R, t, R_gt, t_gt):
    """Translation error of the relative pose ``T_gt o T^{-1}``, per sample."""
    dR = R_gt @ np.swapaxes(R, -1, -2)
    return np.linalg.norm(t_gt - np.einsum("bij,bj->bi", dR, t), axis=-1)


@pytest.mark.parametrize("name,schedule", [("color", None),
                                           ("color", ((2, 10), (1, 6), (0, 4)))])
def test_rgbd_odometry_converges(name, schedule):
    """``tests/test_baselines.py``'s photometric thresholds on the port:
    the translation error falls below 0.6 of the identity's."""
    arrays, (R_gt, t_gt) = _photometric_scene(B=1)
    tracker = pb.RGBDOdometry(term=name, max_iter=5, schedule=schedule)
    R, t = _port(tracker, arrays)
    t0 = _error(np.eye(3)[None], np.zeros((1, 3)), R_gt, t_gt).max()
    assert _error(R, t, R_gt, t_gt).max() < 0.6 * t0 + 1e-5


def test_point2point_odometry_converges():
    """``tests/test_baselines.py``'s point-to-point thresholds on the port:
    a 3 cm step toward the surface comes back within 1.5 cm, R within 0.02."""
    arrays = _depth_scene(1, 48, 64, tz=0.03, fx=40.0)
    R, t = _port(pb.ICPOdometry(mode="Point2Point"), arrays)
    assert np.isfinite(t).all() and abs(t[0, 2] + 0.03) < 0.015
    np.testing.assert_allclose(R[0], np.eye(3), atol=0.02)


def test_icp_moves_toward_the_surface():
    for mode in ("Point2Plane", "Iter_Point2Plane"):
        _, t = _port(pb.ICPOdometry(mode=mode), _depth_scene(2, 32, 40))
        assert (t[:, 2] < -0.005).all(), (mode, t)


def test_divergence_guard(monkeypatch):
    """A sample with ``||t|| > 1`` comes back as the identity; a NaN pose
    (a failed solve) comes back NaN, as the JAX package's guard lets it
    through; the others are unchanged.  The JAX guard on the same tracks
    gives the same arrays (NaN in the same places)."""
    tracker = pb.ICPOdometry()
    R = torch.from_numpy(np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]),
                                   np.full((3, 3), np.nan)]).astype(np.float32))
    t = torch.tensor([[0.0, 5.0, 0.0], [0.3, 0.2, 0.1], [float("nan")] * 3])
    monkeypatch.setattr(tracker, "track", lambda *a: (R * 2, t.clone()))
    scene = [torch.from_numpy(a) for a in _depth_scene(3, 8, 8)]
    R_out, t_out = tracker.batch_track(*scene)
    torch.testing.assert_close(R_out[0], torch.eye(3), rtol=0, atol=0)
    torch.testing.assert_close(t_out[0], torch.zeros(3), rtol=0, atol=0)
    for i in (1, 2):
        torch.testing.assert_close(R_out[i], R[i] * 2, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(t_out[i], t[i], rtol=0, atol=0, equal_nan=True)
    jax_tracker = jb.ICPOdometry()
    jax_tracker._jit = lambda *a: ((R * 2).numpy(), t.numpy())
    R_ref, t_ref = jax_tracker.batch_track(*(a.numpy() for a in scene))
    np.testing.assert_array_equal(R_out.numpy(), R_ref)
    np.testing.assert_array_equal(t_out.numpy(), t_ref)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        tracker.batch_track(*scene, batch_objmask0=scene[1])
    with pytest.raises(ValueError, match="baseline"):
        pb.make_baseline("Open3D")


# ---------------------------------------------------------------- the CLI

RESIZE, BATCH = 0.1, 2


def _save_pil(path, array):
    Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path) \
        if array.dtype == np.uint16 else Image.fromarray(array).save(path)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    seq = str(tmp_path_factory.mktemp("tum") / "seq")
    write_tum_sequence(seq, n=5, save=_save_pil)
    return seq


def _summary(path):
    with open(path) as f:
        return {row[0]: row[1:] for row in csv.reader(f)}


def _counting(monkeypatch, calls):
    for mod, name in ((tw, "gather_twohot"), (tw, "gather_tiles"), (tj, "fused_jtj_jtr")):
        def call(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)


def _dumps(seq):
    """The per-frame results the evaluate CLI dumped beside the sequence."""
    out = {}
    for kf in (1, 2):
        with open(f"{seq}_keyframe_{kf}.pkl", "rb") as f:
            out[kf] = pickle.load(f)
    return out


@pytest.mark.parametrize("tracker,per_batch,pose_atol,rtol", [
    ("ICP", {"gather_twohot": 40}, 5e-3, 1e-2),
    ("RGBD", {"gather_twohot": 80, "fused_jtj_jtr": 40}, 1e-5, 1e-4),
])
def test_evaluate_cli_tracker_matches_jax(sequence, tmp_path, monkeypatch, tracker, per_batch,
                                          pose_atol, rtol):
    """``--tracker`` through both evaluate CLIs on the same files: the
    per-frame poses and the summary tables agree, and the port's kernels
    ran as many times a batch as the baseline's iterations say."""
    args = ["--data_root", "", "--trajectory", sequence, "--keyframes", "1,2",
            "--batch_size", str(BATCH), "--image_resize", str(RESIZE), "--tracker", tracker]
    assert jev.main([*args, "--output_dir", str(tmp_path / "jax")]) == 0
    ref_frames = _dumps(sequence)
    calls = {}
    _counting(monkeypatch, calls)
    assert pev.main([*args, "--output_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    batches = 2 + 1  # keyframe 1: 4 pairs; keyframe 2: 2 pairs
    assert calls == {k: n * batches for k, n in per_batch.items()}
    dR = 0.0
    for kf, info in _dumps(sequence).items():
        ref = ref_frames[kf]
        assert info["names"] == ref["names"]
        for name in ("R_est", "t_est"):
            np.testing.assert_allclose(info[name], ref[name], atol=pose_atol, rtol=0,
                                       err_msg=name)
        dR = max(dR, float(np.abs(info["R_est"] - ref["R_est"]).max()))
    # the angle error moves by what the two packages' R difference moves
    # the trace of R_gt R_est^T (three terms) over sin(angle)
    angles = np.concatenate([ref_frames[kf]["angular_error"] for kf in (1, 2)])
    angle_atol = np.degrees((0.5 * (4 * EPS32 + 3 * dR) / np.sin(np.maximum(angles, 1e-4))).max())
    got = _summary(tmp_path / "port" / f"nolearning_{tracker}" / "summary.csv")
    ref = _summary(tmp_path / "jax" / f"nolearning_{tracker}" / "summary.csv")
    assert list(got) == list(ref) and len(got) == 7
    header = ref[""]
    assert got[""] == header
    for name, row in list(ref.items())[1:]:
        for col, want, have in zip(header, row, got[name]):
            if col in ("3D EPE", "trans error"):
                np.testing.assert_allclose(float(have), float(want), rtol=rtol,
                                           err_msg=f"{name} {col}")
            elif col == "axis error":
                assert abs(float(have) - float(want)) <= angle_atol, (name, have, want)
            elif col in ("total frames", "keyframe") and want:
                assert float(have) == float(want)


def test_icp_on_the_sequence_matches_jax_in_float64(sequence):
    """The ICP baseline on the sequence's first batch, in float64 in both
    packages (the port on its plain kernels): its in-plane motion is weakly
    observed on the planar scene, so float32 rounding alone moves the
    float32 poses by up to 1e-3 in either package."""
    loader = next(iter(pe.create_eval_loaders("TUM_RGBD", "test", [1], BATCH,
                                              trajectory=sequence, image_resize=RESIZE,
                                              root="").values()))
    batch = next(iter(loader))
    arrays = [np.asarray(batch[k], np.float64)
              for k in ("color0", "depth0", "color1", "depth1", "calib")]
    R_j, t_j = _jax_tracker("ICP").batch_track(*arrays)
    R, t = _port(pb.make_baseline("ICP", plain=True), arrays)
    np.testing.assert_allclose(R, R_j, atol=1e-9, rtol=0)
    np.testing.assert_allclose(t, t_j, atol=1e-9, rtol=0)
