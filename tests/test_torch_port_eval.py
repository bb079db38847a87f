"""PyTorch port vs the JAX package: the RPE error, the two-view evaluation
loop, the summary table and the evaluate CLI.

The fixture is a 640x480 TUM-format sequence of 5 frames
(``chip_smoke.write_tum_sequence``, written with PIL) read at
``image_resize`` 0.1 (48x64), B=2, keyframes 1 and 2; the weights are the
flax ``PRNGKey(7)`` init carried over by ``from_flax``.  Both packages get
the same batches in the same order: the tracker's batch-global reductions
make a frame's pose depend on its batch.  Tolerances:

- ``rotation_angle``, ``between``, ``compute_rpe_error``: 1e-12 in
  float64; in float32 1e-6 on ``between`` and the translation error, and on
  the angle ``4 * eps32 / sin(angle)``: ``arccos`` near 1 turns the
  trace's rounding (a few float32 ulps of 1) into that much angle;
- per-frame R and t of ``evaluate_two_view``: 1e-5; EPE3D 1e-5 relative;
  the translation error 1e-5 relative; the angle error as above, with the
  two packages' R difference added to the trace's error (on this fixture:
  R 1.8e-7 apart, angles 6.6e-6 apart at 0.018 rad, 3.7e-4 relative, which
  a 1e-5 relative bound could not hold);
- ``summarize_results``: 1e-6 relative, on the same per-frame arrays.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch import evaluation as pe
from deep_prob_feature_track_torch import losses as pl
from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.geometry import lie as tl
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.solvers import jacobians as tj
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_torch.training.train import TrainState
from deep_prob_feature_track_tpu import evaluation as je
from deep_prob_feature_track_tpu import losses as jlosses
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)
KEYFRAMES = (1, 2)
RESIZE, BATCH = 0.1, 2


def _rotations(rng, n, scale, dtype):
    return np.asarray(jl.exp_so3(jnp.asarray(rng.randn(n, 3) * scale))).astype(dtype)


def _angle_bound(angle, trace_err=4 * EPS32):
    """What an error ``trace_err`` in the trace of a rotation moves
    ``arccos((trace - 1) / 2)`` at ``angle`` by."""
    return 0.5 * trace_err / np.sin(np.maximum(angle, 1e-4))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rpe_error_matches_jax(rng, dtype):
    n = 16
    R0, R1 = _rotations(rng, n, 0.02, dtype), _rotations(rng, n, 0.5, dtype)
    R0[0] = R1[0]  # the clipped identity
    t0, t1 = (rng.randn(n, 3) * 0.05).astype(dtype), (rng.randn(n, 3) * 0.05).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    got = tl.between(*map(torch.from_numpy, (R0, t0, R1, t1)))
    ref = jl.between(*map(jnp.asarray, (R0, t0, R1, t1)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)
    for a, b in zip(tl.inverse(torch.from_numpy(R0), torch.from_numpy(t0)),
                    jl.inverse(jnp.asarray(R0), jnp.asarray(t0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)
    ang, trs = pl.compute_rpe_error(*map(torch.from_numpy, (R0, t0, R1, t1)))
    ang_j, trs_j = jlosses.compute_rpe_error(*map(jnp.asarray, (R0, t0, R1, t1)))
    assert ang.dtype == torch.from_numpy(R0).dtype
    np.testing.assert_allclose(trs.numpy(), np.asarray(trs_j), atol=tol, rtol=0)
    ang_bound = 1e-12 if dtype == np.float64 else _angle_bound(np.asarray(ang_j))
    assert (np.abs(ang.numpy() - np.asarray(ang_j)) <= ang_bound).all()
    # the identity sits on the clip at 1 - 1e-7
    np.testing.assert_allclose(ang[0].item(), np.arccos(np.asarray(1 - 1e-7, dtype)), rtol=1e-6)
    ref_angle = tl.rotation_angle(torch.from_numpy(R1))
    np.testing.assert_allclose(ref_angle.numpy(), np.asarray(jl.rotation_angle(jnp.asarray(R1))),
                               atol=1e-12 if dtype == np.float64 else 1e-5, rtol=0)


def test_rpe_loss_sums_the_pyramid_as_jax(rng):
    B, L = 3, 5
    R = _rotations(rng, B * L, 0.05, np.float64).reshape(B, L, 3, 3)
    t = rng.randn(B, L, 3) * 0.05
    R_gt, t_gt = _rotations(rng, B, 0.05, np.float64), rng.randn(B, 3) * 0.05
    got = pl.compute_rpe_loss(*map(torch.from_numpy, (R, t, R_gt, t_gt)))
    ref = jlosses.compute_rpe_loss(*map(jnp.asarray, (R, t, R_gt, t_gt)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-12)


# ------------------------------------------------------ evaluate_two_view


def _save_pil(path, array):
    Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path) \
        if array.dtype == np.uint16 else Image.fromarray(array).save(path)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    seq = str(tmp_path_factory.mktemp("tum") / "seq")
    write_tum_sequence(seq, n=5, save=_save_pil)
    return seq


def _loaders(mod, seq):
    return mod.create_eval_loaders("TUM_RGBD", "test", KEYFRAMES, BATCH, trajectory=seq,
                                   image_resize=RESIZE, root="")


@pytest.fixture(scope="module")
def evaluated(sequence):
    """The JAX and the port evaluation of every loader, on the same weights,
    and the port tracker."""
    first = next(iter(_loaders(je, sequence).values()))
    example = next(iter(first))
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(example[k]) for k in pe.KEYS]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    fwd = jax.jit(lambda *a: net.apply(v, *a, train=False))
    ref = {k: je.evaluate_two_view(loader, fwd) for k, loader in _loaders(je, sequence).items()}
    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    got = {k: pe.evaluate_two_view(loader, port, "cpu")
           for k, loader in _loaders(pe, sequence).items()}
    return got, ref, port


def test_evaluate_two_view_matches_jax(evaluated):
    got, ref, _ = evaluated
    assert list(got) == list(ref) and len(got) == 2
    for key in got:
        g, r = got[key], ref[key]
        assert g["names"] == r["names"] and len(g["names"]) == (4 if key.endswith("1") else 2)
        for name in ("R_est", "t_est"):
            np.testing.assert_allclose(g[name], r[name], atol=1e-5, rtol=0, err_msg=name)
        for name in ("epes", "translation_error"):
            np.testing.assert_allclose(g[name], r[name], rtol=1e-5, atol=0, err_msg=name)
        # the trace of R_gt R_est^T moves by the rounding of the product and
        # by the two packages' R difference (three terms)
        trace_err = 4 * EPS32 + 3 * np.abs(g["R_est"] - r["R_est"]).max()
        gap = np.abs(g["angular_error"] - r["angular_error"])
        assert (gap <= _angle_bound(r["angular_error"], trace_err)).all(), gap
        assert np.isfinite(g["epes"]).all() and (g["epes"] > 0).all()


def test_summarize_results_matches_jax(evaluated, tmp_path):
    _, ref, _ = evaluated
    table = pe.summarize_results(ref, KEYFRAMES, output_csv=str(tmp_path / "p" / "s.csv"),
                                 dump_dir=str(tmp_path / "p"))
    df = je.summarize_results(ref, KEYFRAMES, output_csv=str(tmp_path / "j" / "s.csv"))
    assert list(table) == list(df.index)
    for name, row in table.items():
        for col in pe.COLUMNS:
            want = df.loc[name, col]
            if col == "trajectory":
                assert row.get(col, "") == ("" if want != want else want)
            elif col in row:
                np.testing.assert_allclose(float(row[col]), float(want), rtol=1e-6)
            else:
                assert want != want  # NaN in the DataFrame
    got_csv = (tmp_path / "p" / "s.csv").read_text().splitlines()
    ref_csv = (tmp_path / "j" / "s.csv").read_text().splitlines()
    assert got_csv[0] == ref_csv[0] and len(got_csv) == len(ref_csv) == 7
    assert [r.split(",")[0] for r in got_csv] == [r.split(",")[0] for r in ref_csv]
    for key, info in ref.items():
        with open(os.path.join(str(tmp_path / "p"), key + ".pkl"), "rb") as f:
            dumped = pickle.load(f)
        assert dumped["names"] == info["names"]
        np.testing.assert_array_equal(dumped["R_est"], info["R_est"])


def _counting(monkeypatch, calls):
    """Count the kernel wrappers' calls, as the warp and the normal
    equations make them."""
    for mod, name in ((tw, "gather_twohot"), (tw, "gather_tiles"), (tw, "gather_twohot_grads"),
                      (tw, "gather_tiles_grads"), (tj, "fused_jtj_jtr")):
        def call(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)


def test_evaluate_cli_on_cpu(evaluated, sequence, tmp_path, monkeypatch, capsys):
    """``apps.evaluate.main`` with the port's weights as a training state:
    its per-frame poses are ``evaluate_two_view``'s bit for bit, K1 and K6
    run 12 times a batch and nothing else does."""
    got, _, port = evaluated
    state = TrainState(net=port, optimizer=torch.optim.SGD(port.parameters(), 0.1), step=3)
    ckpt = checkpoints.save_train_state(str(tmp_path / "ckpt.pt"), state)
    calls = {}
    _counting(monkeypatch, calls)
    rc = pev.main(["--data_root", "", "--trajectory", sequence, "--keyframes", "1,2",
                   "--batch_size", str(BATCH), "--image_resize", str(RESIZE),
                   "--checkpoint", ckpt, "--output_dir", str(tmp_path / "out"),
                   "--device", "cpu", "--time"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "forward step" in out and "EPE3D=" in out
    batches = 2 + 1  # keyframe 1: 4 pairs; keyframe 2: 2 pairs
    assert calls == {"gather_twohot": 12 * batches, "fused_jtj_jtr": 12 * batches}
    text = (tmp_path / "out" / "ckpt" / "summary.csv").read_text()
    assert "mean values of trajectories keyframe 1" in text
    for key, info in got.items():
        # the loaders are named by the sequence's path: the dumps lie beside it
        with open(key + ".pkl", "rb") as f:
            dumped = pickle.load(f)
        for name in ("R_est", "t_est", "epes", "angular_error"):
            np.testing.assert_array_equal(dumped[name], info[name], err_msg=name)


# Every option the CLIs refused before ROADMAP items 5, 6 and 8 runs now.
# On one process (a mesh of one rank) the sharded runs give the plain run's
# bits, and --debug_nan leaves a finite step as it is; --time (the JAX train
# CLI's flag, which it never reads) changes nothing.
EVAL_FLAGS = [["--mesh"], ["--dataset", "ScanNet"], ["--mesh", "--dataset", "VaryLighting"]]
TRAIN_FLAGS = [["--accum_steps", "2"], ["--mesh"], ["--distributed"], ["--debug_nan"],
               ["--dataset", "ScanNet"], ["--time"]]


@pytest.fixture(scope="module")
def roots(sequence, tmp_path_factory):
    """Dataset roots: the TUM sequence's folder (its name patched into
    ``TUM_TRAINVAL`` for the train CLI), a VaryLighting scene of its first
    3 frames, and a 5-frame ScanNet scan (``chip_smoke.write_scannet_scan``)
    under both ``train/`` and ``val/``."""
    import shutil

    from chip_smoke import write_scannet_scan

    base = tmp_path_factory.mktemp("roots")
    for sub in ("rgb", "depth"):
        os.makedirs(base / "vl" / "scene0" / sub)
        for name in sorted(os.listdir(os.path.join(sequence, sub)))[:3]:
            shutil.copy(os.path.join(sequence, sub, name), base / "vl" / "scene0" / sub / name)
    write_scannet_scan(str(base / "scannet" / "val" / "scene0011_00"), n=5)
    shutil.copytree(base / "scannet" / "val", base / "scannet" / "train")
    return {"TUM_RGBD": os.path.dirname(sequence), "VaryLighting": str(base / "vl"),
            "ScanNet": str(base / "scannet")}


def _dataset(flags):
    return flags[flags.index("--dataset") + 1] if "--dataset" in flags else "TUM_RGBD"


def _run_eval(roots, sequence, out, flags=()):
    dataset = _dataset(list(flags))
    traj = {"TUM_RGBD": sequence, "VaryLighting": "scene0", "ScanNet": "scene0011_00"}[dataset]
    root = "" if dataset == "TUM_RGBD" else roots[dataset]
    assert pev.main(["--dataset", dataset, "--data_root", root, "--trajectory", traj,
                     "--keyframes", "1", "--batch_size", "2", "--image_resize", str(RESIZE),
                     "--output_dir", str(out), "--device", "cpu",
                     *[f for f in flags if f not in ("--dataset", dataset)]]) == 0
    (ckpt_dir,) = out.iterdir()
    return {p.name: p.read_bytes() for p in ckpt_dir.iterdir()}


def _run_train(roots, out, flags=()):
    from deep_prob_feature_track_torch.data import tum as ptum
    from deep_prob_feature_track_torch.utils import logger as plogger

    dataset = _dataset(list(flags))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptum, "TUM_TRAINVAL", {"fx": ["seq"]})
        mp.setattr(plogger, "_tb_writer", lambda logdir: None)  # TensorFlow's import
        assert ptr.main(["--dataset", dataset, "--data_root", roots[dataset], "--keyframes", "1",
                         "--batch_size", "2", "--image_resize", str(RESIZE), "--epochs", "1",
                         "--max_steps_per_epoch", "1", "--no_val", "--checkpoint_folder",
                         str(out), "--device", "cpu",
                         *[f for f in flags if f not in ("--dataset", dataset)]]) == 0
    (logdir,) = out.iterdir()
    lines = (logdir / "metrics.jsonl").read_text().splitlines()
    return [v["value"] for v in map(json.loads, lines) if v["tag"] == "train/loss"]


@pytest.mark.parametrize("cli,flags", [(pev, f) for f in EVAL_FLAGS]
                         + [(ptr, f) for f in TRAIN_FLAGS])
def test_cli_runs_what_it_refused(cli, flags, roots, sequence, tmp_path):
    dataset = _dataset(flags)
    if cli is pev:
        got = _run_eval(roots, sequence, tmp_path / "got", flags)
        assert "summary.csv" in got  # (a TUM path's dumps land beside the sequence)
        if "--mesh" in flags:
            assert got == _run_eval(roots, sequence, tmp_path / "ref", ["--dataset", dataset])
        return
    losses = _run_train(roots, tmp_path / "got", flags)
    assert len(losses) == 1 and np.isfinite(losses[0]) and losses[0] > 0
    if dataset == "TUM_RGBD" and "--accum_steps" not in flags:
        assert losses == _run_train(roots, tmp_path / "ref")


def test_timers_and_profile_trace(tmp_path):
    from deep_prob_feature_track_torch.utils.timers import Timers, profile_trace

    timers = Timers(block=True)
    with profile_trace(str(tmp_path / "trace")):
        for _ in range(2):
            with timers.time("stage"):
                torch.ones(8).sum()
        timers.tic("other")
        timers.toc("other")
    assert timers.counts == {"stage": 2, "other": 1} and timers.mean("stage") > 0
    assert "stage" in timers.summary() and "x2" in timers.summary()
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"stage"' in trace  # the record_function range
