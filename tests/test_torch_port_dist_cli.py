"""The CLIs over a ``torch.distributed`` group: two gloo processes on the
CPU, as ``torchrun`` starts them, against one process.

Each rank runs, in turn, ``evaluate --mesh``, ``ba_refine --sharded`` and
``train --mesh`` with ``torchrun``'s environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), on an 8-frame TUM-format
sequence (``chip_smoke.write_tum_sequence``) read at ``image_resize`` 0.1
(48x64), with the port's seeded ``feature`` weights.  Each rank gets an
output path of its own, so that rank 1's must stay empty: rank 0 alone
writes.  In float32, as the CLIs run:

- ``evaluate --mesh``, B=4 (2 a rank) over keyframe 1's 7 pairs, the last
  batch padded: the per-frame poses and metrics of rank 0's dumps within
  the evaluate CLI's 1e-4 of the one-process CLI's (the ranks track their
  rows with the batch-global min/max over the whole batch; a rank's
  convolutions run on 2 rows where one process runs 4);
- ``ba_refine --sharded``, 4 frames and a window of 2: 5 edges, padded with
  a zero-information sixth to split 3 and 3: rank 0's trajectory file
  within 3e-6 of the one-process CLI's (three units of the file's sixth
  decimal, as ``tests/test_torch_port_ba_refine.py`` holds the CLI against
  the JAX CLI; here the ranks' H and b are float32 sums in another order);
- ``train --mesh``, one step at a global batch of 4: each rank loads its
  own shard (``BatchLoader(shard_index=rank, num_shards=2)``, B=2).  The
  reference is one process's step on the two shards' first batches, each
  loaded as its rank loads it (a fresh dataset, the colour jitter drawn
  from its own seeded stream, the shuffle drawn once for ``len`` before
  the epoch's): the checkpoint's BatchNorm running statistics within 1e-5
  of their largest entry (float32 sums over the ranks against sums over
  the batch: 2.5e-7 apart here), and the logged loss within 1e-3
  relative.  The loss comes out of 12 chained Gauss-Newton solves on
  random weights, which amplify float32 rounding: on this batch one
  process's float32 loss lies 4.0e-4 from its float64 loss, and the ranks'
  8.5e-5 from one process's.
  The parameters are not held: a first Adam step moves each by about
  ``lr * sign(g)``, so a float32 gradient entry near 0 (a bias before a
  BatchNorm) moves it anywhere within ``lr``.
"""

import json
import os
import pickle
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps import ba_refine as pba
from deep_prob_feature_track_torch.apps import evaluate as pev
from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.data.association import write_sync_trajectory
from deep_prob_feature_track_torch.data.pipeline import BatchLoader, to_device
from deep_prob_feature_track_torch.data.tum_dicts import TUM_TRAINVAL
from deep_prob_feature_track_torch.parallel import mesh as pmesh
from deep_prob_feature_track_torch.training import checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
WORLD = 2
RESIZE = "0.1"
SEED = 1


def _eval_args(seq, out):
    return ["--data_root", "", "--trajectory", seq, "--keyframes", "1", "--batch_size", "4",
            "--image_resize", RESIZE, "--output_dir", out, "--device", "cpu"]


def _ba_args(seq, out):
    return ["--data_root", "", "--trajectory", seq, "--image_resize", RESIZE, "--window", "2",
            "--iterations", "3", "--max_frames", "4", "--output", out, "--device", "cpu"]


def _train_args(root, out):
    return ["--data_root", root, "--keyframes", "1,2", "--batch_size", "4",
            "--image_resize", RESIZE, "--epochs", "1", "--max_steps_per_epoch", "1", "--no_val",
            "--checkpoint_folder", out, "--seed", str(SEED), "--device", "cpu"]


def worker(rank: int, ports, workdir: str) -> None:
    """One rank: the three CLIs in turn, each joining a group of its own
    from the environment, as under ``torchrun``."""
    from deep_prob_feature_track_torch.utils import logger

    torch.set_num_threads(1)
    logger._tb_writer = lambda logdir: None  # TensorBoard's import is not under test
    os.environ.update(MASTER_ADDR="localhost", RANK=str(rank), WORLD_SIZE=str(WORLD))
    out = os.path.join(workdir, f"rank{rank}")
    seq = os.path.join(workdir, "seq_mesh")
    runs = [(pev, _eval_args(seq, os.path.join(out, "eval")) + ["--mesh"]),
            (pba, _ba_args(seq, os.path.join(out, "ba.txt")) + ["--sharded"]),
            (ptr, _train_args(os.path.join(workdir, "trainval"), os.path.join(out, "train"))
             + ["--mesh"])]
    for port, (cli, args) in zip(ports, runs):
        os.environ["MASTER_PORT"] = str(port)
        assert cli.main(args) == 0
        assert not pmesh.dist.is_initialized()


def _train_reference(root):
    """One process's step on the global batch the two ranks load."""
    from deep_prob_feature_track_torch.data.loader import load_data
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    args = ptr.build_argparser().parse_args(_train_args(root, ""))
    shards = []
    for rank in range(WORLD):
        random.seed(SEED)  # as main() seeds each rank before its data is built
        np.random.seed(SEED)
        data = load_data("TUM_RGBD", [1, 2], "train", image_resize=float(RESIZE), root=root,
                         augment_seed=SEED)
        loader = BatchLoader(data, args.batch_size // WORLD, shuffle=True, seed=SEED,
                             drop_last=True, shard_index=rank, num_shards=WORLD, prefetch=0)
        len(loader)  # the CLI's steps_per_epoch: one draw of the shuffle before the epoch's
        shards.append(next(iter(loader)))
    batch = {k: np.concatenate([s[k] for s in shards]) for k, v in shards[0].items()
             if not isinstance(v, list)}
    batch = to_device(batch, "cpu")
    batch["pad_mask"] = torch.as_tensor(batch["pad_mask"])
    tcfg = ptr.train_config(args)
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature")), tcfg, seed=SEED,
                                  device="cpu")
    state, metrics = tt.make_train_step(tcfg, 1)(state, batch)
    return metrics["loss"].item(), state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from deep_prob_feature_track_torch.utils import logger

    work = tmp_path_factory.mktemp("dist_cli")
    write_tum_sequence(str(work / "seq_mesh"), n=8)
    shutil.copytree(work / "seq_mesh", work / "seq_one")
    shutil.copytree(work / "seq_mesh", work / "seq_train")
    os.makedirs(work / "trainval")
    names = [n for names in TUM_TRAINVAL.values() for n in names]
    for name in names:
        os.symlink(work / "seq_train", work / "trainval" / name)
    # each sequence's association cache, written once before the ranks read it
    for seq in ("seq_mesh", "seq_one", f"trainval/{names[0]}"):
        write_sync_trajectory(str(work / seq))

    ports = set()
    while len(ports) < 3:
        ports.add(pmesh.free_port())
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_port_dist_cli", str(r),
                               ",".join(map(str, sorted(ports))), str(work)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    saved = logger._tb_writer
    try:
        logger._tb_writer = lambda logdir: None
        assert pev.main(_eval_args(str(work / "seq_one"), str(work / "one" / "eval"))) == 0
        assert pba.main(_ba_args(str(work / "seq_one"), str(work / "one" / "ba.txt"))) == 0
        train_ref = _train_reference(str(work / "trainval"))
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        logger._tb_writer = saved
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return work, train_ref


def _files(path):
    return [os.path.join(d, f) for d, _, names in os.walk(path) for f in names]


def test_rank_one_writes_nothing(runs):
    work, _ = runs
    assert _files(work / "rank1") == []
    assert _files(work / "rank0" / "eval") and (work / "rank0" / "ba.txt").exists()
    assert _files(work / "rank0" / "train")


def test_evaluate_mesh_matches_one_process(runs):
    work, _ = runs
    with open(work / "seq_mesh_keyframe_1.pkl", "rb") as f:
        got = pickle.load(f)
    with open(work / "seq_one_keyframe_1.pkl", "rb") as f:
        ref = pickle.load(f)
    assert got["R_est"].shape == ref["R_est"].shape == (7, 3, 3)
    for k in ("R_est", "t_est", "epes", "angular_error", "translation_error"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0, err_msg=k)
    (summary,) = [p for p in _files(work / "rank0" / "eval") if p.endswith("summary.csv")]
    assert "mean values of trajectories keyframe 1," in open(summary).read()


def test_ba_refine_sharded_with_an_odd_edge_count_matches_one_process(runs):
    work, _ = runs
    assert len(pba.window_pairs(4, 2)) % WORLD == 1
    got = np.loadtxt(work / "rank0" / "ba.txt")
    ref = np.loadtxt(work / "one" / "ba.txt")
    assert got.shape == ref.shape == (4, 8)
    np.testing.assert_allclose(got, ref, atol=3e-6, rtol=0)


def test_train_mesh_step_matches_one_process_on_the_global_batch(runs):
    work, (loss, state) = runs
    (logdir,) = (work / "rank0" / "train").iterdir()
    lines = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [x["tag"] for x in lines] == ["train/loss", "train/steps_per_sec", "train/epoch_loss"]
    assert abs(lines[0]["value"] - loss) <= 1e-3 * abs(loss)
    final = checkpoints.restore_variables(str(logdir / "checkpoint_epoch1.pt"))
    assert final["step"] == 1 and final["skipped"] == 0
    ref = state.net.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        scale = ref[k].abs().max().item()
        assert (final["net"][k] - ref[k]).abs().max().item() <= 1e-5 * scale, k


if __name__ == "__main__":
    worker(int(sys.argv[1]), [int(p) for p in sys.argv[2].split(",")], sys.argv[3])
