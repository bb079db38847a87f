"""The non-finite step guard (``make_train_step(guard_nonfinite=True)``)
against the JAX package's.

A batch with one NaN depth map makes the loss and the gradient norm NaN:
the guarded step flags ``skipped`` and leaves the parameters, the Adam
state (moments and per-parameter step) and the BatchNorm running
statistics bit for bit as they were, while ``state.step`` advances (and
the learning-rate schedule's update count does not, as optax's count in
the kept optimizer state does not, also across a checkpoint and a
resume).  A finite batch gives the same bits with and without the guard.
The JAX guard skips the same batch.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models import tracker as jtracker
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)
B, H, W = 2, 16, 20


def _batch(seed, nan=False):
    batch = tt.synthetic_batch(B, H, W, seed=seed, device="cpu")
    if nan:
        batch["depth0"][0] = float("nan")
    return batch


def _state(cfg):
    net = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    return tt.create_train_state(net, cfg, seed=7, device="cpu")


def _snapshot(state):
    return (copy.deepcopy(state.net.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()["state"]))


def _equal(a, b):
    (net_a, opt_a), (net_b, opt_b) = a, b
    assert net_a.keys() == net_b.keys() and opt_a.keys() == opt_b.keys()
    for k in net_a:
        assert torch.equal(net_a[k], net_b[k]), k
    for i in opt_a:
        for k in opt_a[i]:
            assert torch.equal(opt_a[i][k], opt_b[i][k]), (i, k)


def test_a_nan_batch_is_skipped_bit_for_bit():
    cfg = tt.TrainConfig()
    state = _state(cfg)
    step = tt.make_train_step(cfg, steps_per_epoch=10, guard_nonfinite=True)
    state, metrics = step(state, _batch(1))  # Adam's moments are nonzero from here
    assert not metrics["skipped"] and state.skipped == 0
    before = _snapshot(state)
    state, metrics = step(state, _batch(2, nan=True))
    assert bool(metrics["skipped"])
    assert not torch.isfinite(metrics["loss"]) or not torch.isfinite(metrics["grad_norm"])
    assert state.step == 2 and state.skipped == 1
    _equal(_snapshot(state), before)
    state, metrics = step(state, _batch(3))  # and training goes on
    assert not metrics["skipped"] and state.step == 3 and state.skipped == 1


def test_a_finite_batch_gives_the_same_bits_with_and_without_the_guard():
    cfg = tt.TrainConfig()
    runs = []
    for guard in (False, True):
        state = _state(cfg)
        step = tt.make_train_step(cfg, steps_per_epoch=10, guard_nonfinite=guard)
        for seed in (1, 2):
            state, metrics = step(state, _batch(seed))
        runs.append((_snapshot(state), metrics["loss"], metrics["grad_norm"]))
    _equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])


def test_without_the_guard_a_nan_batch_poisons_the_weights():
    cfg = tt.TrainConfig()
    state = _state(cfg)
    state, _ = tt.make_train_step(cfg, steps_per_epoch=10)(state, _batch(2, nan=True))
    assert not all(torch.isfinite(p).all() for p in state.net.parameters())


# the schedule's first decay falls at update 2 (one-step epochs): a count
# that took the skipped step for an update would halve the learning rate
LR_CFG = dict(lr_decay_epochs=(2,))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX guarded step, from the port's seeded weights, on a finite
    batch and then the NaN batch: the states before and after each."""
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    net = jtracker.LeastSquareTracking(cfg=jp.get_preset("feature"))
    cfg = dataclasses.replace(jt.TrainConfig(), **LR_CFG)
    optimizer = jt.make_optimizer(cfg, 1)
    states = [jt.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                            batch_stats=v["batch_stats"], opt_state=optimizer.init(v["params"]))]
    metrics = []
    with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")  # 2/3 of the unrolled loop's compile time
        step = jt.make_train_step(net, cfg, optimizer, guard_nonfinite=True)
        for batch in (_batch(1), _batch(2, nan=True)):
            new, m = step(states[-1], {k: jnp.asarray(t.numpy()) for k, t in batch.items()})
            states.append(new)
            metrics.append(m)
    return cfg, states, metrics


def test_the_jax_guard_skips_the_same_batch(jax_steps):
    _, states, metrics = jax_steps
    assert not bool(metrics[0]["skipped"]) and bool(metrics[1]["skipped"])
    assert int(states[2].step) == 2
    for a, b in zip(jax.tree.leaves((states[2].params, states[2].batch_stats,
                                     states[2].opt_state)),
                    jax.tree.leaves((states[1].params, states[1].batch_stats,
                                     states[1].opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_resume_after_a_skipped_step_keeps_the_learning_rate_of_jax(jax_steps, tmp_path):
    """A checkpoint keeps the count of skipped steps: resumed after a finite
    and a skipped step, the port's next update takes the learning rate
    that the JAX schedule gives the update count in its kept optimizer
    state (1, before the decay), not the step count's (2)."""
    import optax

    from deep_prob_feature_track_torch.training import checkpoints

    jcfg, states, _ = jax_steps
    (count,) = [int(s.count) for s in states[2].opt_state
                if isinstance(s, optax.ScaleByScheduleState)]
    cfg = tt.TrainConfig(**LR_CFG)
    step = tt.make_train_step(cfg, steps_per_epoch=1, guard_nonfinite=True)
    state = _state(cfg)
    state, _ = step(state, _batch(1))
    state, metrics = step(state, _batch(2, nan=True))
    assert bool(metrics["skipped"])
    path = checkpoints.save_train_state(str(tmp_path / "s.pt"), state)
    resumed = checkpoints.restore_train_state(path, _state(cfg))
    assert (resumed.step, resumed.skipped) == (2, 1)
    resumed, metrics = step(resumed, _batch(3))
    assert not bool(metrics["skipped"]) and count == 1
    lr = resumed.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, float(jt.make_lr_schedule(jcfg, 1)(count)), rtol=1e-6)
    assert lr == cfg.lr != tt.make_lr_schedule(cfg, 1)(resumed.step - 1)
