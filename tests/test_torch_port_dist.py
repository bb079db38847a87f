"""Data parallelism over a ``torch.distributed`` group (``parallel/mesh.py``):
two gloo processes on the CPU against one process on the global batch, and
against the JAX package's mesh of two devices.

A JAX mesh step is the global program, sharded, so the port's two-rank run
must be its one-process run on the global batch: BatchNorm statistics,
batch-global min/max and the loss mean over the global batch, gradients
summed over the ranks.  In float64 (the kernels' plain versions), from the
port's seeded ``feature`` weights (carried to the JAX package by its
``convert_state_dict``), on ``synthetic_batch``'s scenes at 32x40 with a
global batch of 4 (2 a rank):

- two training steps: the first loss and gradient norm within 1e-12
  relative, the second's within 1e-10 (they start from weights the first
  update moved within the bound below), the BatchNorm statistics (which
  the second step moves) within 1e-10 of their largest entry, the parameters within what a gradient
  1e-12 of its clipped norm apart moves two Adam updates
  (``tests/test_torch_port_accum.py``'s bound);
- one ``accum_steps=2`` step, whose global microbatches of 2 are split 1
  and 1 over the ranks (the JAX scan mode): its loss, gradient norm and
  statistics within 1e-12, its parameters within one update's bound;
- the two training steps again with ``remat_gn`` and ``remat_encoder``,
  whose replays in the backward all-reduce BatchNorm's sums once more, in
  the same order on both ranks: on each rank the unrolled steps' bits;
- the eval forward's poses, gathered from the ranks, within 1e-12;
- the sharded pose graph (10 edges, 5 a rank) within 1e-12;
- the sharded dense window (``tests/test_torch_port_dense_ba.py``'s
  textured plane, 5 edges padded with a zero-weight sixth, a varied sigma
  and ``remove_tru_sigma``, whose min/max is each shard's own, as inside
  the JAX package's ``shard_map``) within 1e-10, as that file holds the
  unsharded window.

The references: the port's one process on the global batch (the first
four) and the JAX package on ``make_mesh(jax.devices()[:2])`` (all five):
``make_train_step(mesh=...)`` in its scan mode, the jitted eval forward on
inputs placed with ``batch_sharding``, ``refine_pose_graph_sharded`` and
``refine_dense_window(mesh=...)``.  Both ranks end with the same bits.
Per-rank BatchNorm statistics or per-rank min/max
(``DistributedDataParallel``'s semantics) fail the train and eval cases.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.parallel import ba as pba
from deep_prob_feature_track_torch.parallel import dense_ba as pdb
from deep_prob_feature_track_torch.parallel import mesh as pmesh
from deep_prob_feature_track_torch.training import train as tt

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 4, 32, 40
WORLD = 2
SEEDS = (3, 4)


def _global_batch(seed):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in tt.synthetic_batch(B, H, W, seed=seed, device="cpu").items()}


def _state(accum=1, **modes):
    cfg = tt.TrainConfig(accum_steps=accum)
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=True,
                              **modes).reset_parameters(7)
    net.double().train()
    return cfg, tt.TrainState(net=net, optimizer=tt.make_optimizer(cfg, net.parameters()))


def _train(mesh):
    """Two steps, then one accumulated step from fresh weights; with a
    mesh each rank passes its rows of the global batches."""
    out = {}
    cfg, state = _state()
    step = tt.make_train_step(cfg, 10, mesh=mesh)
    for i, seed in enumerate(SEEDS):
        batch = _global_batch(seed)
        state, m = step(state, batch if mesh is None else pmesh.shard_batch(mesh, batch))
        out[f"loss{i}"], out[f"norm{i}"] = m["loss"].item(), m["grad_norm"].item()
    out.update({f"train/{k}": v.numpy() for k, v in state.net.state_dict().items()})
    cfg, state = _state(accum=2)
    batch = _global_batch(5)
    state, m = tt.make_train_step(cfg, 10, mesh=mesh)(
        state, batch if mesh is None else pmesh.shard_batch(mesh, batch))
    out["accum_loss"], out["accum_norm"] = m["loss"].item(), m["grad_norm"].item()
    out.update({f"accum/{k}": v.numpy() for k, v in state.net.state_dict().items()})
    return out


def _rematted_steps(mesh):
    """The two steps of :func:`_train` with the rematerialized training
    modes, on each rank's rows."""
    out = {}
    cfg, state = _state(remat_gn=True, remat_encoder=True)
    step = tt.make_train_step(cfg, 10, mesh=mesh)
    for i, seed in enumerate(SEEDS):
        state, m = step(state, pmesh.shard_batch(mesh, _global_batch(seed)))
        out[f"remat_loss{i}"], out[f"remat_norm{i}"] = m["loss"].item(), m["grad_norm"].item()
    out.update({f"remat/{k}": v.numpy() for k, v in state.net.state_dict().items()})
    return out


def _eval_forward(mesh):
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=True).reset_parameters(7)
    net.double().eval()
    batch = _global_batch(6)
    keys = ("color0", "color1", "depth0", "depth1", "calib")
    rows = slice(None) if mesh is None else pmesh.batch_sharding(mesh, B)
    with torch.inference_mode(), pmesh.active(mesh):
        R, t = net(*(batch[k][rows] for k in keys))
        if mesh is not None:
            R, t = pmesh.all_gather_rows(mesh, R), pmesh.all_gather_rows(mesh, t)
    return {"eval_R": R.numpy(), "eval_t": t.numpy()}


def _pose_graph_problem():
    """Poses, pairs, measurements and information matrices of a window
    graph of 8 poses and 10 edges."""
    rng = np.random.RandomState(4)
    n = 8
    poses = np.tile(np.eye(4), (n, 1, 1))
    for k in range(1, n):
        poses[k, :3, 3] = poses[k - 1, :3, 3] + rng.randn(3) * 0.1
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, 4), (2, 6), (1, 7)]
    meas = [(np.eye(3) + 0.01 * rng.randn(3, 3), rng.randn(3) * 0.1) for _ in pairs]
    A = rng.randn(len(pairs), 6, 6)
    return poses, pairs, meas, list(A @ A.transpose(0, 2, 1) + np.eye(6))


def _pose_graph(mesh):
    graph = pba.build_window_graph(*_pose_graph_problem(), device="cpu")
    if mesh is None:
        refined, costs = pba.refine_pose_graph(graph, iterations=5)
    else:
        refined, costs = pba.refine_pose_graph_sharded(graph, mesh, iterations=5)
    return {"pg_R": refined.R.numpy(), "pg_t": refined.t.numpy(), "pg_costs": costs.numpy()}


def _dense_inputs(path):
    d = np.load(path)
    frames = pdb.WindowFrames(*(torch.from_numpy(d[k]) for k in ("feats", "sigmas", "invD", "K")))
    return frames, *(torch.from_numpy(d[k]) for k in ("R", "t", "ei", "ej", "w"))


def _dense(mesh, path):
    frames, R, t, ei, ej, w = _dense_inputs(path)
    R, t, costs = pdb.refine_dense_window(frames, R, t, ei, ej, edge_weights=w, iterations=3,
                                          remove_tru_sigma=True, plain=True, mesh=mesh)
    return {"dense_R": R.numpy(), "dense_t": t.numpy(), "dense_costs": costs.numpy()}


def worker(rank: int, port: int, outdir: str) -> None:
    """One rank of the two-process run: everything above on its shard,
    saved to ``outdir/rank{rank}.npz``."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh("cpu", init_method=f"tcp://localhost:{port}", rank=rank,
                           world_size=WORLD)
    try:
        out = {**_train(mesh), **_rematted_steps(mesh), **_eval_forward(mesh),
               **_pose_graph(mesh), **_dense(mesh, os.path.join(outdir, "dense.npz"))}
    finally:
        pmesh.destroy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)


# ------------------------------------------------- the JAX package's mesh


def _jax_mesh_runs(dense, part):
    """Everything above through the JAX package on a mesh of two devices,
    in float64, from the port's seeded weights: the two training steps
    (``part="steps"``, the longest compile), or the rest."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from deep_prob_feature_track_torch.models.from_flax import from_flax
    from deep_prob_feature_track_tpu.models import presets as jp
    from deep_prob_feature_track_tpu.models import tracker as jtracker
    from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
    from deep_prob_feature_track_tpu.parallel import ba as jba
    from deep_prob_feature_track_tpu.parallel import dense_ba as jdb
    from deep_prob_feature_track_tpu.parallel.mesh import batch_sharding, replicated
    from deep_prob_feature_track_tpu.parallel.mesh import make_mesh as jax_mesh
    from deep_prob_feature_track_tpu.training import train as jt
    from tests.test_torch_port_uncer import _Float64Numpy

    mesh = jax_mesh(jax.devices()[:WORLD])
    v = convert_state_dict(LeastSquareTracking(get_preset("feature")).reset_parameters(7)
                           .state_dict())
    assert v.pop("unmapped") == {}
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    net = jtracker.LeastSquareTracking(cfg=jp.get_preset("feature"), dtype=jnp.float64)

    def jax_batch(seed):
        return {k: jnp.asarray(t.numpy()) for k, t in _global_batch(seed).items()}

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "jnp", _Float64Numpy())
        mp.setattr(jt, "jnp", _Float64Numpy())  # the scan mode's float32 loss carry
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        for prefix, accum, seeds in (("train", 1, SEEDS), ("accum", 2, (5,))):
            if (prefix == "train") != (part == "steps"):
                continue
            cfg = dataclasses.replace(jt.TrainConfig(), accum_steps=accum, accum_loop="scan")
            optimizer = jt.make_optimizer(cfg, 10)
            # placed as the step returns it, so that the second step reuses the first's program
            state = jax.device_put(jt.TrainState(
                step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                opt_state=optimizer.init(v["params"])), replicated(mesh))
            step = jt.make_train_step(net, cfg, optimizer, mesh=mesh)
            for i, seed in enumerate(seeds):
                state, m = step(state, jax_batch(seed))
                names = ("accum_loss", "accum_norm") if accum > 1 else (f"loss{i}", f"norm{i}")
                out[names[0]], out[names[1]] = float(m["loss"]), float(m["grad_norm"])
            weights = from_flax(jax.tree.map(np.asarray, {"params": state.params,
                                                          "batch_stats": state.batch_stats}),
                                np.float64)
            out.update({f"{prefix}/{k}": t.numpy() for k, t in weights.items()})
        if part == "steps":
            return out
        sharding = batch_sharding(mesh)
        batch = jax_batch(6)
        R, t = jax.jit(lambda *a: net.apply(v, *a, train=False))(
            *(jax.device_put(batch[k], sharding)
              for k in ("color0", "color1", "depth0", "depth1", "calib")))
        out.update(eval_R=np.asarray(R), eval_t=np.asarray(t))
    refined, costs = jba.refine_pose_graph_sharded(
        jba.build_window_graph(*_pose_graph_problem()), mesh, iterations=5)
    out.update(pg_R=np.asarray(refined.R), pg_t=np.asarray(refined.t), pg_costs=np.asarray(costs))
    frames = jdb.WindowFrames(*(jnp.asarray(dense[k]) for k in ("feats", "sigmas", "invD", "K")))
    R, t, costs = jdb.refine_dense_window(
        frames, jnp.asarray(dense["R"]), jnp.asarray(dense["t"]),
        jnp.asarray(dense["ei"], jnp.int32), jnp.asarray(dense["ej"], jnp.int32),
        edge_weights=jnp.asarray(dense["w"]), iterations=3, remove_tru_sigma=True, mesh=mesh)
    out.update(dense_R=np.asarray(R), dense_t=np.asarray(t), dense_costs=np.asarray(costs))
    return out


# ---------------------------------------------------------------- the test


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the one-process run's and the JAX mesh's."""
    from tests.test_torch_port_dense_ba import perturb, render_window, window_edges

    outdir = tmp_path_factory.mktemp("dist")
    rng = np.random.RandomState(0)
    frames, poses_gt = render_window(rng)
    poses = perturb(poses_gt, rng)
    ei, ej = window_edges(len(poses))
    ei, ej = np.append(ei, 0), np.append(ej, 1)  # a zero-weight sixth edge
    dense = {"feats": np.asarray(frames.feats, np.float64),
             "sigmas": 0.5 + np.asarray(frames.feats, np.float64) ** 2,
             "invD": np.asarray(frames.invD, np.float64), "K": np.asarray(frames.K, np.float64),
             "R": poses[:, :3, :3].astype(np.float64), "t": poses[:, :3, 3].astype(np.float64),
             "ei": ei, "ej": ej, "w": np.array([1.0] * 5 + [0.0])}
    np.savez(outdir / "dense.npz", **dense)

    port = pmesh.free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    # the two ranks, and the JAX mesh's training steps beside the rest
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_port_dist", *args,
                               str(outdir)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for args in [(str(r), str(port)) for r in range(WORLD)] + [("jax",)]]
    try:
        one = {**_train(None), **_eval_forward(None), **_pose_graph(None)}
        jax_ref = _jax_mesh_runs(dense, "rest")
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(outdir / f"rank{r}.npz")) for r in range(WORLD)]
    jax_ref.update(np.load(outdir / "jax_steps.npz"))
    return got, {"one_process": one, "jax_mesh": jax_ref}


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_the_ranks_end_with_the_same_bits(runs):
    got, _ = runs
    assert got[0].keys() == got[1].keys()
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def _check_training(got, ref, prefix):
    first = ("loss0", "norm0") if prefix == "train" else ("accum_loss", "accum_norm")
    for k in first:
        assert _rel(got[k], ref[k]) <= 1e-12, k
    if prefix == "train":  # from weights the first update moved within the bound below
        for k in ("loss1", "norm1"):
            assert _rel(got[k], ref[k]) <= 1e-10, k
    # each update moves within lr * 1e-12 * |clipped g| / (4 eps) (see the module)
    cfg = tt.TrainConfig()
    steps = 2 if prefix == "train" else 1
    bound = steps * cfg.lr * 1e-12 * cfg.grad_clip / (4 * 1e-8)
    keys = [k for k in ref if k.startswith(prefix + "/")]
    assert keys and all(k in got for k in keys)
    for k in keys:
        if k.endswith("num_batches_tracked"):
            assert got[k] == ref[k], k
        elif k.endswith(("running_mean", "running_var")):  # the second step's as its loss
            assert _rel(got[k], ref[k]) <= (1e-10 if prefix == "train" else 1e-12), k
        else:
            assert np.abs(got[k] - ref[k]).max() <= bound, k


@pytest.mark.parametrize("prefix", ["train", "accum"])
def test_training_steps_match_one_process_on_the_global_batch(runs, prefix):
    _check_training(runs[0][0], runs[1]["one_process"], prefix)


@pytest.mark.parametrize("prefix", ["train", "accum"])
def test_training_steps_match_the_jax_mesh(runs, prefix):
    ref = {k: v for k, v in runs[1]["jax_mesh"].items() if not k.endswith("num_batches_tracked")}
    _check_training(runs[0][0], ref, prefix)


def test_rematted_steps_on_two_ranks_keep_the_unrolled_bits(runs):
    for got in runs[0]:
        for i in range(len(SEEDS)):
            assert got[f"remat_loss{i}"] == got[f"loss{i}"]
            assert got[f"remat_norm{i}"] == got[f"norm{i}"]
        keys = [k for k in got if k.startswith("train/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(got["remat/" + k[len("train/"):]], got[k], err_msg=k)


def _check_eval(got, ref):
    for k in ("eval_R", "eval_t"):
        assert got[k].shape == ref[k].shape and _rel(got[k], ref[k]) <= 1e-12, k


def test_eval_forward_matches_one_process_on_the_global_batch(runs):
    _check_eval(runs[0][0], runs[1]["one_process"])


def test_eval_forward_matches_the_jax_mesh(runs):
    _check_eval(runs[0][0], runs[1]["jax_mesh"])


def _check_pose_graph(got, ref):
    for k in ("pg_R", "pg_t", "pg_costs"):
        assert _rel(got[k], ref[k]) <= 1e-12, k


def test_sharded_pose_graph_matches_the_refinement(runs):
    _check_pose_graph(runs[0][0], runs[1]["one_process"])


def test_sharded_pose_graph_matches_the_jax_mesh(runs):
    _check_pose_graph(runs[0][0], runs[1]["jax_mesh"])


def test_sharded_dense_window_matches_the_jax_mesh(runs):
    (got, _), ref = runs[0], runs[1]["jax_mesh"]
    np.testing.assert_allclose(got["dense_R"], ref["dense_R"], atol=1e-10, rtol=0)
    np.testing.assert_allclose(got["dense_t"], ref["dense_t"], atol=1e-10, rtol=0)
    assert _rel(got["dense_costs"], ref["dense_costs"]) <= 1e-10


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        import tests.conftest  # noqa: F401  (JAX on a CPU mesh of 8 devices, in x64)

        outdir = sys.argv[2]
        np.savez(os.path.join(outdir, "jax_steps.npz"),
                 **_jax_mesh_runs(dict(np.load(os.path.join(outdir, "dense.npz"))), "steps"))
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
