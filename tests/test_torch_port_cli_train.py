"""PyTorch port vs the JAX package: the RPE training loss, SGD, the epoch
loop, checkpoints and the train CLI.

B=2 at 32x40 (``synthetic_batch``, seed 3) with the flax ``PRNGKey(7)``
weights for the loss; tolerances:

- the RPE loss of one ``compute_loss``: 1e-4 relative to the JAX loss;
  each gradient leaf within 5e-3 of the leaf's largest JAX entry, the
  envelope of 12 chained Gauss-Newton solves
  (``tests/test_torch_port_train.py``); the wiring of the RPE backward
  through the custom autograd Functions against autograd through the plain
  ops, in float64: rtol 1e-6, atol 1e-6 of each leaf's largest entry;
- three SGD steps against optax's ``trace(0.9)`` chain on fixed gradients:
  atol 1e-6;
- two steps, a checkpoint, a restore and two more steps against four
  uninterrupted steps: bit for bit on the CPU;
- a step resumed under another weight decay against optax's chain built
  with it from the saved moments: atol 1e-6;
- the training memory modes' flags reach the tracker, and a rematted CLI
  step's checkpoint equals the unrolled one's bit for bit.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch.apps import train as ptr
from deep_prob_feature_track_torch.data import pipeline as pp
from deep_prob_feature_track_torch.data import tum as ptum
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.kernels import FusedJtJ, jtj_jtr_ref
from deep_prob_feature_track_torch.training import checkpoints
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_torch.training.train import TrainState
from deep_prob_feature_track_torch.utils import logger as plogger
from deep_prob_feature_track_tpu import evaluation as je
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
B, H, W = 2, 32, 40
RPE = tt.TrainConfig(loss="RPE")


@pytest.fixture(scope="module")
def rpe_loss_and_grads():
    """JAX and port RPE loss and parameter gradients of one training batch,
    from the same ``PRNGKey(7)`` weights."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=3, device="cpu").items()}
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(batch[k]) for k in ("color0", "color1", "depth0", "depth1", "calib")]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(loss="RPE"), p, s, bb),
        has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")  # compiles faster, same loss
        (loss_j, _), grads_j = fn(v["params"], v["batch_stats"],
                                  {k: jnp.asarray(a) for k, a in batch.items()})
    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    port.train()
    loss_t = tt.compute_loss(port, RPE, {k: torch.from_numpy(a) for k, a in batch.items()})
    loss_t.backward()
    return {
        "loss": (loss_t.detach().item(), float(loss_j)),
        "grads": ({k: p.grad for k, p in port.named_parameters()},
                  from_flax({"params": jax.tree.map(np.asarray, grads_j)})),
    }


def test_rpe_loss_matches_jax(rpe_loss_and_grads):
    got, ref = rpe_loss_and_grads["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_rpe_loss_gradients_match_jax(rpe_loss_and_grads):
    got, ref = rpe_loss_and_grads["grads"]
    assert set(got) == set(ref) and len(ref) == 79
    for key, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)


def test_rpe_backward_matches_plain_autograd_in_float64(monkeypatch):
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in tt.synthetic_batch(B, 16, 20, seed=1, device="cpu").items()}
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=True).reset_parameters(2)
    state = copy.deepcopy(net.state_dict())

    def loss_and_grads():
        net.load_state_dict(state)
        net.double().train().zero_grad()
        loss = tt.compute_loss(net, RPE, batch)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    loss, grads = loss_and_grads()
    monkeypatch.setattr(tw.BilinearGather, "apply", lambda operand, u, v, plain: (
        tw.gather_twohot_ref(operand, *tw._corner_weights(operand.shape, u, v))))
    monkeypatch.setattr(FusedJtJ, "apply", lambda *a: jtj_jtr_ref(*a[:5], sign=a[5]))
    ref_loss, ref = loss_and_grads()
    assert abs(loss - ref_loss) <= 1e-9 * abs(ref_loss)
    for key, r in ref.items():
        torch.testing.assert_close(grads[key], r, rtol=1e-6, atol=1e-6 * r.abs().max().item(),
                                   msg=key)


def test_sgd_matches_optax_trace(rng):
    cfg = tt.TrainConfig(opt="sgd", lr_decay_epochs=(1, 2))
    params = [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params]
             for s in (0.5, 10.0, 3.0)]
    tx = jt.make_optimizer(jt.TrainConfig(opt="sgd", lr_decay_epochs=(1, 2)), steps_per_epoch=1)
    p_j = [jnp.asarray(p) for p in params]
    state = tx.init(p_j)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, p_j)
        p_j = optax.apply_updates(p_j, updates)
    p_t = [torch.from_numpy(p).requires_grad_() for p in params]
    optimizer = tt.make_optimizer(cfg, p_t)
    assert isinstance(optimizer, torch.optim.SGD)
    schedule = tt.make_lr_schedule(cfg, steps_per_epoch=1)
    for step, g in enumerate(grads):
        for p, x in zip(p_t, g):
            p.grad = torch.tensor(x)
        tt.clip_gradients(p_t, cfg.grad_clip)
        tt.apply_update(optimizer, schedule(step))
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="optimizer"):
        tt.make_optimizer(tt.TrainConfig(opt="lamb"), p_t)


# ------------------------------------------------- epochs and checkpoints


class _Batches:
    """A dataset of ``synthetic_batch`` samples (16x20), one per index."""

    def __init__(self, n):
        full = tt.synthetic_batch(n, 16, 20, seed=4, device="cpu")
        self.items = [{k: v[i].numpy() for k, v in full.items() if k != "pad_mask"}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i], name={"index": i})


def _state(seed=1):
    return tt.create_train_state(LeastSquareTracking(get_preset("feature")), tt.TrainConfig(),
                                 seed=seed, device="cpu")


@pytest.fixture
def no_tensorboard(monkeypatch):
    """JSONL logs alone: where TensorFlow is installed, importing
    TensorBoard's writer imports it too (~10 s)."""
    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)


def test_train_epoch_steps_and_logs(tmp_path, no_tensorboard):
    loader = pp.BatchLoader(_Batches(8), batch_size=2, shuffle=True, seed=3, drop_last=True)
    state, step = _state(), tt.make_train_step(tt.TrainConfig(), steps_per_epoch=4)
    seen = []

    def recording_step(state, batch):
        assert batch["pad_mask"].dtype == torch.bool and "name" not in batch
        state, metrics = step(state, batch)
        seen.append(metrics["loss"].item())
        return state, metrics

    logger = plogger.MetricsLogger(str(tmp_path / "log"))
    state, mean = tt.train_epoch(recording_step, state, loader, "cpu", log_every=2,
                                 logger=logger, max_steps=3)
    logger.close()
    assert state.step == 3 and len(seen) == 3
    np.testing.assert_allclose(mean, np.mean(seen), rtol=1e-6)
    lines = [json.loads(x)
             for x in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [(x["tag"], x["step"]) for x in lines] == [
        ("train/loss", 1), ("train/steps_per_sec", 1), ("train/loss", 3),
        ("train/steps_per_sec", 3)]
    assert lines[0]["value"] == pytest.approx(seen[0], rel=1e-6)


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    batches = [tt.synthetic_batch(B, 16, 20, seed=10 + i, device="cpu") for i in range(4)]
    cfg = tt.TrainConfig(lr_decay_epochs=(1,))
    step = tt.make_train_step(cfg, steps_per_epoch=2)  # the decay falls in between
    whole = _state()
    for b in batches:
        whole, _ = step(whole, b)
    half = _state()
    for b in batches[:2]:
        half, _ = step(half, b)
    path = checkpoints.save_train_state(str(tmp_path / "ckpt" / "s.pt"), half)
    resumed = checkpoints.restore_train_state(path, _state(seed=9))
    assert resumed.step == 2
    for b in batches[2:]:
        resumed, _ = step(resumed, b)
    for (k, a), b in zip(whole.net.state_dict().items(), resumed.net.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for a, b in zip(whole.optimizer.state.values(), resumed.optimizer.state.values()):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    # the weights alone, and a tracker's weights out of a training state
    raw = checkpoints.restore_variables(path)
    assert set(raw) == {"net", "optimizer", "step", "skipped"} and raw["skipped"] == 0
    assert checkpoints.tracker_weights(raw) is raw["net"]
    bare = checkpoints.save_variables(str(tmp_path / "w.pt"), half.net.state_dict())
    assert checkpoints.tracker_weights(checkpoints.restore_variables(bare)).keys() == \
        half.net.state_dict().keys()


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_resume_takes_the_current_optimizer_hyperparameters(tmp_path, rng, opt):
    """A training state saved with one weight decay and resumed under
    another takes its next step with the new one and the saved moments,
    as the JAX optax chain built with the new value does from the same
    moments (atol 1e-6)."""
    first = tt.TrainConfig(opt=opt, lr=1e-2, weight_decay=4e-4)
    second = tt.TrainConfig(opt=opt, lr=1e-2, weight_decay=5e-2)
    grads = [[rng.randn(*shape).astype(np.float32) * 0.1 for shape in ((4, 3), (4,))]
             for _ in range(2)]

    def step(state, cfg, g):
        for p, x in zip(state.net.parameters(), g):
            p.grad = torch.from_numpy(x)
        tt.clip_gradients(list(state.net.parameters()), cfg.grad_clip)
        tt.apply_update(state.optimizer, tt.make_lr_schedule(cfg, 1)(state.step))
        state.step += 1

    torch.manual_seed(0)
    net = torch.nn.Linear(3, 4)
    state = TrainState(net=net, optimizer=tt.make_optimizer(first, net.parameters()))
    step(state, first, grads[0])
    path = checkpoints.save_train_state(str(tmp_path / "s.pt"), state)
    net = torch.nn.Linear(3, 4)
    resumed = checkpoints.restore_train_state(
        path, TrainState(net=net, optimizer=tt.make_optimizer(second, net.parameters())))
    assert resumed.step == 1
    assert resumed.optimizer.param_groups[0]["weight_decay"] == second.weight_decay
    moments = [{k: v.clone() for k, v in resumed.optimizer.state[p].items()}
               for p in net.parameters()]
    for p, saved in zip(net.parameters(), state.optimizer.state.values()):
        for k, v in saved.items():
            torch.testing.assert_close(resumed.optimizer.state[p][k], v, rtol=0, atol=0)
    p_j = [jnp.asarray(p.detach().numpy().copy()) for p in net.parameters()]
    step(resumed, second, grads[1])

    tx = jt.make_optimizer(jt.TrainConfig(opt=opt, lr=second.lr,
                                          weight_decay=second.weight_decay), steps_per_epoch=1)
    js = list(tx.init(p_j))
    if opt == "adam":
        js[2] = js[2]._replace(count=jnp.asarray(1, jnp.int32),
                               mu=[jnp.asarray(m["exp_avg"].numpy()) for m in moments],
                               nu=[jnp.asarray(m["exp_avg_sq"].numpy()) for m in moments])
    else:
        js[2] = js[2]._replace(trace=[jnp.asarray(m["momentum_buffer"].numpy())
                                      for m in moments])
    updates, _ = tx.update([jnp.asarray(x) for x in grads[1]], tuple(js), p_j)
    for got, want in zip(net.parameters(), optax.apply_updates(p_j, updates)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- the CLI


def _save_pil(path, array):
    if array.dtype == np.uint16:
        Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path)
    else:
        Image.fromarray(array).save(path)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    write_tum_sequence(str(root / "seq"), n=8, save=_save_pil)
    return str(root)


@pytest.fixture
def trainval(monkeypatch):
    """The train split names the fixture's sequence (as
    ``tests/test_eval_train_cli.py`` points the JAX CLI at its fixture)."""
    monkeypatch.setattr(ptum, "TUM_TRAINVAL", {"fx": ["seq"]})


def _train_args(data_root, tmp_path, *extra):
    return ["--data_root", data_root, "--keyframes", "1,2", "--batch_size", "2",
            "--image_resize", "0.1", "--checkpoint_folder", str(tmp_path / "logs"),
            "--device", "cpu", *extra]


def test_train_cli_takes_every_flag_of_the_jax_cli():
    """The JAX train CLI's flags, ``--time`` ("stage timing", never read)
    among them, parse in the port's CLI with the same help; the port adds
    only ``--device`` and the training memory modes, which the JAX CLI
    takes from environment variables (``--train_loop``,
    ``--remat_encoder``, ``--bf16_residuals``)."""
    from deep_prob_feature_track_tpu.apps import train as jax_cli

    def flags(parser):
        return {s: a for a in parser._actions for s in a.option_strings}

    port, ref = flags(ptr.build_argparser()), flags(jax_cli.build_argparser())
    assert set(port) - set(ref) == {"--device", "--train_loop", "--remat_encoder",
                                    "--bf16_residuals"} and set(ref) <= set(port)
    assert port["--time"].help == ref["--time"].help == "stage timing"
    assert ptr.build_argparser().parse_args(["--time"]).time is True
    assert ptr.build_argparser().parse_args([]).time is False


def test_train_cli_trains_saves_and_resumes(data_root, trainval, no_tensorboard, tmp_path,
                                            capsys):
    assert ptr.main(_train_args(data_root, tmp_path, "--epochs", "1",
                                "--max_steps_per_epoch", "2", "--no_val")) == 0
    out = capsys.readouterr().out
    (logdir,) = (tmp_path / "logs").iterdir()
    assert logdir.name.startswith("TUM_RGBD_ConvRGBD2_None_Direct-Nodamping_uCh_1_laplacian")
    assert {p.name for p in logdir.glob("*.pt")} == {"checkpoint_epoch0.pt",
                                                     "checkpoint_epoch1.pt"}
    assert "epoch 0: loss=" in out and "step=2)" in out
    final = checkpoints.restore_variables(str(logdir / "checkpoint_epoch1.pt"))
    assert final["step"] == 2 and final["optimizer"]["state"]
    losses = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([x["value"] for x in losses]).all()
    # resume for one more step: one-step epochs put step 2 at epoch 2
    assert ptr.main(_train_args(data_root, tmp_path, "--epochs", "3",
                                "--max_steps_per_epoch", "1", "--no_val",
                                "--checkpoint", str(logdir / "checkpoint_epoch1.pt"))) == 0
    assert "resumed from" in capsys.readouterr().out
    resumed = checkpoints.restore_variables(str(logdir / "checkpoint_epoch3.pt"))
    assert resumed["step"] == 3
    steps = resumed["optimizer"]["state"][0]["step"]
    assert steps.item() == final["optimizer"]["state"][0]["step"].item() + 1


def test_train_cli_validation_on_tum_stops_as_the_jax_cli(data_root, trainval, no_tensorboard,
                                                          tmp_path):
    """Without ``--no_val`` the validation loaders read the four TUM test
    sequences' validation part, which no training sequence holds: they are
    empty, and the JAX CLI's ``info["epes"]`` meets a result whose metric
    keys were dropped.  The port stops the same way."""
    loaders = je.create_eval_loaders("TUM_RGBD", "validation", [1, 2], 2, root=data_root)
    assert len(loaders) == 8 and all(len(loader) == 0 for loader in loaders.values())
    assert "epes" not in je.evaluate_two_view(next(iter(loaders.values())), None)
    with pytest.raises(KeyError, match="epes"):
        ptr.main(_train_args(data_root, tmp_path, "--epochs", "1",
                             "--max_steps_per_epoch", "1"))


def test_train_cli_modes_reach_the_tracker_and_keep_the_bits(tmp_path, monkeypatch):
    """``--train_loop scan_remat --remat_encoder`` set the tracker's
    ``remat_gn`` and ``remat_encoder``, ``--bf16_residuals`` its
    ``bf16_residuals``; the rematted CLI's checkpoint after a step is the
    unrolled CLI's bit for bit."""
    write_tum_sequence(str(tmp_path / "data" / "seq"), n=6)
    monkeypatch.setattr(ptum, "TUM_TRAINVAL", {"fx": ["seq"]})
    monkeypatch.setattr(plogger, "_tb_writer", lambda logdir: None)
    made = []
    create = tt.create_train_state

    def recording(net, *a, **kw):
        made.append((net.remat_gn, net.remat_encoder, net.bf16_residuals))
        return create(net, *a, **kw)

    monkeypatch.setattr(tt, "create_train_state", recording)

    def run(name, *flags):
        assert ptr.main(["--data_root", str(tmp_path / "data"), "--keyframes", "1",
                         "--batch_size", "2", "--image_resize", "0.1", "--epochs", "1",
                         "--max_steps_per_epoch", "1", "--no_val", "--device", "cpu",
                         "--checkpoint_folder", str(tmp_path / name), *flags]) == 0
        (path,) = (tmp_path / name).glob("*/checkpoint_epoch1.pt")
        return checkpoints.restore_variables(str(path))

    ref = run("unroll")
    got = run("remat", "--train_loop", "scan_remat", "--remat_encoder")
    run("bf16", "--bf16_residuals")
    assert made == [(False, False, False), (True, True, False), (False, False, True)]
    assert ref["step"] == got["step"] == 1
    for key, v in ref["net"].items():
        assert torch.equal(got["net"][key], v), key
    for i, st in ref["optimizer"]["state"].items():
        for key, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][key], v), (i, key)
