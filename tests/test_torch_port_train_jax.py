"""PyTorch port vs the JAX package: one ``feature`` training step against
the JAX package's compiled step, from the flax ``PRNGKey(7)`` weights on
``synthetic_batch``'s scene (B=2 at 32x40, seed 3).  The flax init is one
program for every step here, so it is compiled once, in ``feature_init``.

- the EPE3D ``compute_loss``: the loss within 1e-4 relative; each gradient
  leaf within atol 5e-3 of the leaf's largest JAX entry, the envelope of
  12 chained Gauss-Newton solves
  (``tests/test_training.py::test_scan_remat_loop_gradient_parity``); the
  BatchNorm running statistics after the step within rtol 1e-5 (atol 1e-7
  for entries near zero).  The batch is ``synthetic_batch``'s smooth
  textured scene, seed 3, whose worst leaf is well inside the envelope;
  some other seeds flip one pixel of a discrete mask (occlusion, sigma
  min/max) between the two roundings and leave it.  On uniform-noise images
  the float32 gradient is chaotic beyond the envelope, even between the JAX
  package's own float32 and float64 runs, so the wiring of the backward is
  also held tightly in float64 (``tests/test_torch_port_train.py``);
- the RPE loss: the same bounds against the JAX loss under
  ``DPFT_TRAIN_LOOP=scan_remat`` (the same loss, compiled faster);
- the rematerialized modes (``remat_gn`` and ``remat_encoder``) against
  the JAX step under ``DPFT_TRAIN_LOOP=scan_remat`` and
  ``DPFT_REMAT_ENCODER=1``: the EPE3D step's bounds, loss, gradients and
  statistics.  The port's rematted steps against its unrolled ones, bit
  for bit, are in ``tests/test_torch_port_remat.py``;
- ``bf16_residuals`` with the other two modes against the JAX step under
  ``DPFT_BF16_RESIDUALS=1`` and ``DPFT_TRAIN_LOOP=scan_remat``: the loss
  and gradient bounds.  The maps, the warp and the trained gathers are
  held in ``tests/test_torch_port_bf16_residuals.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

B, H, W = 2, 32, 40
RPE = tt.TrainConfig(loss="RPE")


@pytest.fixture(scope="module")
def feature_init():
    """The batch (numpy) and the flax ``PRNGKey(7)`` variables of the
    ``feature`` tracker, initialized on it."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=3, device="cpu").items()}
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(batch[k]) for k in ("color0", "color1", "depth0", "depth1", "calib")]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    return batch, v


def _port_step(variables, batch, cfg, **modes):
    """The port's loss (a tensor, after its backward) and tracker, from the
    flax variables."""
    port = LeastSquareTracking(get_preset("feature"), **modes)
    port.load_state_dict(from_flax(copy.deepcopy(jax.tree.map(np.asarray, dict(variables)))),
                         strict=True)
    port.train()
    loss = tt.compute_loss(port, cfg, {k: torch.from_numpy(a) for k, a in batch.items()})
    loss.backward()
    return loss, port


# ------------------------------------------------------------- EPE3D


@pytest.fixture(scope="module")
def loss_and_grads(feature_init):
    """JAX and port loss, parameter gradients and BatchNorm statistics of one
    training batch, from the same ``PRNGKey(7)`` weights."""
    batch, v = feature_init
    net = JaxTracker(cfg=jp.get_preset("feature"))
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    (loss_j, stats_j), grads_j = fn(v["params"], v["batch_stats"],
                                    {k: jnp.asarray(a) for k, a in batch.items()})
    loss_t, port = _port_step(v, batch, tt.TrainConfig())
    return {
        "loss": (loss_t.detach().item(), float(loss_j)),
        "grads": ({k: p.grad for k, p in port.named_parameters()},
                  from_flax({"params": jax.tree.map(np.asarray, grads_j)})),
        "stats": (port.state_dict(), from_flax({"batch_stats": jax.tree.map(np.asarray,
                                                                            stats_j)})),
        "grad_norm": float(optax.global_norm(grads_j)),
    }


def test_compute_loss_matches_jax(loss_and_grads):
    got, ref = loss_and_grads["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_loss_gradients_match_jax(loss_and_grads):
    got, ref = loss_and_grads["grads"]
    assert set(got) == set(ref) and len(ref) == 79
    for key, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)
    norm = torch.sqrt(sum((g * g).sum() for g in got.values())).item()
    assert abs(norm - loss_and_grads["grad_norm"]) <= 5e-3 * loss_and_grads["grad_norm"]


def test_batchnorm_running_stats_match_flax(loss_and_grads):
    got, ref = loss_and_grads["stats"]
    stat_keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 46
    for key in stat_keys:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    # two encoder passes and the pose net: every BatchNorm counted its batches
    assert got["encoder.net0.0.1.num_batches_tracked"].item() == 2
    assert got["pose_predictor.net.0.1.num_batches_tracked"].item() == 1


# --------------------------------------------------------------- RPE


@pytest.fixture(scope="module")
def rpe_loss_and_grads(feature_init):
    """JAX and port RPE loss and parameter gradients of one training batch,
    from the same ``PRNGKey(7)`` weights."""
    batch, v = feature_init
    net = JaxTracker(cfg=jp.get_preset("feature"))
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(loss="RPE"), p, s, bb),
        has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")  # compiles faster, same loss
        (loss_j, _), grads_j = fn(v["params"], v["batch_stats"],
                                  {k: jnp.asarray(a) for k, a in batch.items()})
    loss_t, port = _port_step(v, batch, RPE)
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


# ------------------------------------------------- the memory modes


@pytest.fixture(scope="module")
def jax_remat_step(feature_init):
    """The JAX package's ``feature`` loss, gradients and BatchNorm
    statistics under ``DPFT_TRAIN_LOOP=scan_remat`` and
    ``DPFT_REMAT_ENCODER=1``."""
    batch, v = feature_init
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        mp.setenv("DPFT_REMAT_ENCODER", "1")
        net = JaxTracker(cfg=jp.get_preset("feature"))
        fn = jax.jit(jax.value_and_grad(
            lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
        (loss, stats), grads = fn(v["params"], v["batch_stats"],
                                  {k: jnp.asarray(a) for k, a in batch.items()})
    return {"loss": float(loss),
            "grads": from_flax({"params": jax.tree.map(np.asarray, grads)}),
            "stats": from_flax({"batch_stats": jax.tree.map(np.asarray, stats)})}


def test_rematted_step_matches_jax_scan_remat(feature_init, jax_remat_step):
    ref = jax_remat_step
    loss, net = _port_step(feature_init[1], feature_init[0], tt.TrainConfig(), remat_gn=True,
                           remat_encoder=True)
    assert abs(loss.item() - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert grads.keys() == ref["grads"].keys()
    for key, r in ref["grads"].items():
        r = r.numpy()
        np.testing.assert_allclose(grads[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)
    state = net.state_dict()
    stat_keys = [k for k in ref["stats"] if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 46
    for key in stat_keys:
        np.testing.assert_allclose(state[key].numpy(), ref["stats"][key].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert state["encoder.net0.0.1.num_batches_tracked"].item() == 2


@pytest.fixture(scope="module")
def jax_bf16_step(feature_init):
    """The JAX package's ``feature`` loss and gradients under
    ``DPFT_BF16_RESIDUALS=1`` (its loop under ``scan_remat``)."""
    batch, v = feature_init
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_BF16_RESIDUALS", "1")
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        mp.delenv("DPFT_REMAT_ENCODER", raising=False)
        net = JaxTracker(cfg=jp.get_preset("feature"))
        fn = jax.jit(jax.value_and_grad(
            lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
        (loss, _), grads = fn(v["params"], v["batch_stats"],
                              {k: jnp.asarray(a) for k, a in batch.items()})
    return {"loss": float(loss), "grads": from_flax({"params": jax.tree.map(np.asarray, grads)})}


def test_bf16_step_matches_the_jax_bf16_step(feature_init, jax_bf16_step):
    ref = jax_bf16_step
    loss, net = _port_step(feature_init[1], feature_init[0], tt.TrainConfig(), remat_gn=True,
                           remat_encoder=True, bf16_residuals=True)
    assert abs(loss.item() - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert grads.keys() == ref["grads"].keys()
    for key, r in ref["grads"].items():
        r = r.numpy()
        np.testing.assert_allclose(grads[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)
