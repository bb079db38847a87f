"""PyTorch port vs the JAX package: one training loss and backward of the
``DeepIC`` preset on the CPU.

B=2 at 32x40 on ``synthetic_batch`` seed 5, with the port's seeded weights
(seed 7) carried to flax by the JAX package's ``convert_state_dict``.

The reference is the JAX loss run in float64 (weights and inputs), not in
float32: ``DeepIC`` starts at the identity, where the pixels of row 0 and
column 0 warp bitwise onto ``u = 0`` or ``v = 0``, and the occlusion mask's
strict in-view test (``check_occ_prewarped``: ``u > 0``, ``v > 0``) flips them
between programs.  On this batch XLA's float32 program rounds them off 0
and keeps them, the port (float32 and float64) and the JAX float64 program
land on 0 and mask them: 142, 70, 34 and 16 pixels at levels 0-3 of the
first residual.  A flipped pixel's residual is the mask's 1e-3 instead of
the smooth features' ~1e-4, so the JAX float32 poses move 1.7e-2 from its
own float64 ones, and the port's float32 poses 6.9e-7.

Tolerances: the loss within 1e-4 relative of the JAX loss; each gradient
leaf of the encoder and the M-estimator within 5e-3 of the leaf's largest
JAX entry, the envelope of 12 chained Gauss-Newton solves that
``tests/test_torch_port_train_jax.py`` holds the ``feature`` preset to.  The
damping MLP's float32 gradient leaves are 1.5e-2 to 7.2e-2 of their
largest entry from the float64 gradient, and so is the port's own float32
run from its float64 run: the damping reaches the loss through the solves
of ill-conditioned 6x6 systems.  Where the float32 programs mask the same
pixels (the golden inputs with a synthetic motion, a CPU run), the JAX and
port float32 damping leaves agree within 3.4e-5 and both stand 3.4e-2
from float64.  So the float32 damping leaves are held within 1e-1, and
every leaf is held in float64 (the port's plain path against the JAX
float64 gradient) within 1e-6 of its largest entry.  The BatchNorm running
statistics (the M-estimator's chain through the four levels) within rtol
1e-5; the backward through the custom autograd Function against autograd
through the plain ops in float64 within rtol 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models import tracker as jtracker
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

B, H, W = 2, 32, 40
KERNELS = ("gather_twohot", "gather_twohot_grads", "splat_twohot", "gather_tiles",
           "gather_tiles_grads")


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is float64: the JAX tracker casts the
    encoder's outputs to ``jnp.float32`` for the solve, and a float64 run
    must keep them in float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def loss_and_grads():
    """JAX (float64) and port (float32) loss, parameter gradients and
    BatchNorm statistics of one training batch, from the same weights, and
    the port's calls of each kernel wrapper."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=5, device="cpu").items()}
    port = LeastSquareTracking(get_preset("DeepIC")).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    net = JaxTracker(cfg=jp.get_preset("DeepIC"), dtype=jnp.float64)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "jnp", _Float64Numpy())
        (loss_j, stats_j), grads_j = fn(
            v["params"], v["batch_stats"],
            {k: jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)
             for k, a in batch.items()})
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in KERNELS:
            def call(*a, _fn=getattr(tw, name), _name=name):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a)
            mp.setattr(tw, name, call)
        port.train()
        loss_t = tt.compute_loss(port, tt.TrainConfig(), {k: torch.from_numpy(a)
                                                          for k, a in batch.items()})
        loss_t.backward()
    port64 = LeastSquareTracking(get_preset("DeepIC"), plain_kernels=True).reset_parameters(7)
    port64.double().train()
    loss64 = tt.compute_loss(port64, tt.TrainConfig(), {
        k: torch.from_numpy(a.astype(np.float64) if a.dtype == np.float32 else a)
        for k, a in batch.items()})
    loss64.backward()
    return {
        "loss": (loss_t.detach().item(), float(loss_j)),
        "loss64": loss64.item(),
        "grads": ({k: p.grad for k, p in port.named_parameters()},
                  from_flax({"params": jax.tree.map(np.asarray, grads_j)})),
        "grads64": {k: p.grad.float() for k, p in port64.named_parameters()},
        "stats": (port.state_dict(), from_flax({"batch_stats": jax.tree.map(np.asarray,
                                                                            stats_j)})),
        "calls": calls,
    }


def test_loss_matches_jax(loss_and_grads):
    got, ref = loss_and_grads["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_loss_gradients_match_jax(loss_and_grads):
    got, ref = loss_and_grads["grads"]
    assert set(got) == set(ref) and len(ref) == 54  # 12 + 4 conv blocks, 3 dense
    for key, r in ref.items():
        r = r.numpy()
        envelope = 1e-1 if key.startswith("solver_func.") else 5e-3
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=envelope * max(np.abs(r).max(), 1e-12), err_msg=key)
    # the damping MLP and the M-estimator learn
    for key in ("solver_func.net.0.0.weight", "mEst_func.net.0.0.weight"):
        assert got[key].abs().max() > 0, key


def test_loss_and_gradients_match_jax_in_float64(loss_and_grads):
    """The port's plain path in float64 against the JAX float64 loss and
    every gradient leaf, the damping MLP's included."""
    loss, (_, ref) = loss_and_grads["loss"], loss_and_grads["grads"]
    assert abs(loss_and_grads["loss64"] - loss[1]) <= 1e-9 * abs(loss[1])
    got = loss_and_grads["grads64"]
    assert set(got) == set(ref)
    for key, r in ref.items():
        torch.testing.assert_close(got[key], r, rtol=0, atol=1e-6 * r.abs().max().item(),
                                   msg=key)


def test_batchnorm_running_stats_match_flax(loss_and_grads):
    got, ref = loss_and_grads["stats"]
    stat_keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 32
    for key in stat_keys:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    # two encoder passes; the M-estimator once a level
    assert got["encoder.net0.0.1.num_batches_tracked"].item() == 2
    assert got["mEst_func.net.0.1.num_batches_tracked"].item() == 4


def test_training_step_gathers_as_pinned(loss_and_grads):
    """The loss and backward sample through K1's wrapper once (level 3's
    first occlusion depth: neither its operand nor the identity pose needs
    a gradient), K2's 50 times (12 a level, and the three upsamples of the
    prior weights) and K3's 27 times (the 6 x1 warps a level and the
    upsamples; the inverse depth needs no cotangent)."""
    assert loss_and_grads["calls"] == {"gather_twohot": 1, "gather_twohot_grads": 50,
                                       "splat_twohot": 27}


def test_training_backward_matches_plain_autograd_in_float64(monkeypatch):
    """The whole ``DeepIC`` training gradient through the custom autograd
    Function of the gathers equals autograd through the plain gather and
    blend, in float64."""
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in tt.synthetic_batch(B, 16, 20, seed=1, device="cpu").items()}
    net = LeastSquareTracking(get_preset("DeepIC"), plain_kernels=True).reset_parameters(2)
    state = copy.deepcopy(net.state_dict())

    def loss_and_grads():
        net.load_state_dict(state)
        net.double().train().zero_grad()
        loss = tt.compute_loss(net, tt.TrainConfig(), batch)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    loss, grads = loss_and_grads()

    def gather_autograd(operand, u, v, plain):
        return tw.gather_twohot_ref(operand, *tw._corner_weights(operand.shape, u, v))

    monkeypatch.setattr(tw.BilinearGather, "apply", gather_autograd)
    ref_loss, ref = loss_and_grads()
    assert abs(loss - ref_loss) <= 1e-9 * abs(ref_loss)
    for key, r in ref.items():
        torch.testing.assert_close(grads[key], r, rtol=1e-6, atol=1e-6 * r.abs().max().item(),
                                   msg=key)
    assert grads["solver_func.net.2.0.weight"].abs().max() > 0
