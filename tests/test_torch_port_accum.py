"""PyTorch port vs the JAX package: one gradient-accumulation step
(``accum_steps=2``) of the ``feature`` preset.

Both packages run in float64 from the same weights (the port's seeded init
carried over by the JAX package's ``convert_state_dict``) on
``synthetic_batch``'s smooth scene, seed 3, B=4 at 32x40: two microbatches
of 2, each with its own BatchNorm batch statistics, the running statistics
chained from the first to the second, the averaged gradient clipped once
and one Adam update.  The JAX side is its host loop (``accum_loop="host"``,
a jitted microbatch gradient compiled through the JAX package's
``DPFT_TRAIN_LOOP=scan_remat`` loop); the port has one loop, and its CLI
takes both ``--accum_loop`` values to the same step.  Held: the loss and
the gradient norm within 1e-12 relative, the BatchNorm running statistics
within 1e-12 of their largest entry, and each parameter's update within
what a gradient 1e-12 of the global norm apart moves a first Adam update
(``lr * 1e-12 * |g| / (4 * eps)``, 1.3e-8 at ``|g|`` = 1; on this step
the worst entry is 1.8e-10 apart, where its gradient is near ``eps``).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models import tracker as jtracker
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.training import train as jt
from tests.test_torch_port_uncer import _Float64Numpy

torch.set_num_threads(2)
B, H, W = 4, 32, 40
STEPS_PER_EPOCH = 10


def _batch():
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=3, device="cpu").items()}
    return {k: a.astype(np.float64) if a.dtype == np.float32 else a for k, a in batch.items()}


def _port_step(batch):
    cfg = tt.TrainConfig(accum_steps=2)
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=True).reset_parameters(7)
    net.double().train()
    state = tt.TrainState(net=net, optimizer=tt.make_optimizer(cfg, net.parameters()))
    before = copy.deepcopy(net.state_dict())
    state, metrics = tt.make_train_step(cfg, STEPS_PER_EPOCH)(
        state, {k: torch.from_numpy(a) for k, a in batch.items()})
    after = net.state_dict()
    return metrics, {k: after[k] - before[k] for k in before}, after


@pytest.fixture(scope="module")
def steps():
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    net = jtracker.LeastSquareTracking(cfg=jp.get_preset("feature"), dtype=jnp.float64)
    cfg = dataclasses.replace(jt.TrainConfig(), accum_steps=2, accum_loop="host")
    optimizer = jt.make_optimizer(cfg, STEPS_PER_EPOCH)
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=optimizer.init(v["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "jnp", _Float64Numpy())
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        new, metrics = jt.make_train_step(net, cfg, optimizer)(
            state, {k: jnp.asarray(a) for k, a in _batch().items()})
    ref_after = from_flax(jax.tree.map(np.asarray, {"params": new.params,
                                                    "batch_stats": new.batch_stats}), np.float64)
    ref_before = from_flax(v, np.float64)
    ref_delta = {k: ref_after[k] - ref_before[k] for k in ref_after}
    return {"jax": ({k: float(x) for k, x in metrics.items()}, ref_delta, ref_after),
            "port": _port_step(_batch())}


def _param_keys(state_dict):
    return [k for k in state_dict if not k.endswith(("running_mean", "running_var",
                                                     "num_batches_tracked"))]


def test_loss_and_grad_norm_match_jax(steps):
    (ref, _, _), (got, _, _) = steps["jax"], steps["port"]
    assert np.isfinite(ref["loss"]) and ref["grad_norm"] > 0
    for key in ("loss", "grad_norm"):
        assert abs(got[key].item() - ref[key]) <= 1e-12 * abs(ref[key]), key


def test_updates_match_jax_within_adams_bound(steps):
    """A first Adam update is ``-lr * g / (|g| + eps)``: a gradient entry
    off by ``dg`` moves it by at most ``lr * dg / (4 * eps)`` (at ``|g| =
    eps``).  The gradients agree within 1e-12 of the global norm (as the
    norm itself does), so each update is held to that bound; the worst
    entries sit where ``|g|`` is near ``eps``."""
    (ref_m, ref, _), (_, delta, _) = steps["jax"], steps["port"]
    keys = [k for k in _param_keys(delta) if k in ref]
    assert len(keys) == len(_param_keys(delta))
    lr, eps = tt.TrainConfig().lr, 1e-8
    bound = lr * 1e-12 * ref_m["grad_norm"] / (4 * eps)
    worst = max((delta[k] - ref[k]).abs().max().item() for k in keys)
    assert worst <= bound, (worst, bound)
    assert all(delta[k].abs().max() > 0 for k in keys)  # every leaf moved


def test_running_statistics_chain_over_the_microbatches_as_jax(steps):
    (_, _, ref), (_, _, got) = steps["jax"], steps["port"]
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        scale = ref[k].abs().max().item()
        assert (got[k] - ref[k]).abs().max().item() <= 1e-12 * scale, k
    # the second microbatch's statistics moved them again
    counts = {got[k].item() for k in got if k.endswith("num_batches_tracked")}
    assert counts and all(c > 0 and c % 2 == 0 for c in counts)


def test_both_accum_loops_run_the_same_step():
    """``--accum_loop`` is the JAX CLI's compile choice: the port's CLI
    takes both values, says it ignores them, and builds the same step."""
    from deep_prob_feature_track_torch.apps import train as ptr

    parser = ptr.build_argparser()
    cfgs = [ptr.train_config(parser.parse_args(["--accum_steps", "2", "--accum_loop", loop]))
            for loop in ("host", "scan")]
    assert cfgs[0] == cfgs[1] and cfgs[0].accum_steps == 2
    assert "ignored" in parser.format_help().rsplit("--accum_loop", 1)[1].split("--checkpoint")[0]


def test_microbatches_are_the_global_rows_in_order():
    batch = {"color0": torch.arange(8.0).reshape(8, 1), "pad_mask": torch.ones(8, dtype=torch.bool)}
    parts = list(tt.microbatches(batch, 4))
    assert [p["color0"][:, 0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        list(tt.microbatches(batch, 3))

