"""PyTorch port vs the JAX package: one training step of the ``feature_icp``
preset with a learned ICP scale (``scaler=MultiScale2w``).

The port builds the scale from iteration 0's residuals and reuses them in
that iteration's solve; the JAX function computes them twice.  The values
are the same, and so must be the gradients that reach the scale net through
the ICP weights.  Both packages run in float64 from the same weights (the
port's seeded init carried over by the JAX package's ``convert_state_dict``)
on ``synthetic_batch``'s smooth scene, seed 3, B=2 at 32x40, under the
default ``EPE3D`` loss: the loss within 1e-12 relative, and each gradient
leaf within a self-calibrated envelope of its largest entry, as in
``tests/test_torch_port_uncer_train.py``: 1e3 times the largest change of
any leaf (relative to its largest entry) when the port's own float64 step
takes the depth scaled by 1 + 1e-13, floored at 1e-9.  The JAX loss and
gradient compile through the JAX package's ``DPFT_TRAIN_LOOP=scan_remat``
loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models import tracker as jtracker
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.training import train as jt
from tests.test_torch_port_uncer import _Float64Numpy
from tests.test_torch_port_uncer_train import _batch, _worst_leaf

torch.set_num_threads(2)
SCALE = ["scaler=MultiScale2w"]


def _port(float64=True):
    port = LeastSquareTracking(apply_overrides(get_preset("feature_icp"), SCALE),
                               plain_kernels=float64).reset_parameters(7)
    return port.double() if float64 else port


def _port_step(batch, float64=True):
    port = _port(float64)
    port.train()
    value = tt.compute_loss(port, tt.TrainConfig(),
                            {k: torch.from_numpy(a) for k, a in batch.items()})
    value.backward()
    return value.item(), {k: p.grad for k, p in port.named_parameters()}


@pytest.fixture(scope="module")
def steps():
    v = convert_state_dict(_port(float64=False).state_dict())
    assert v.pop("unmapped") == {}
    assert "scalers_0" in v["params"]
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    net = jtracker.LeastSquareTracking(
        cfg=dataclasses.replace(jp.get_preset("feature_icp"), scaler="MultiScale2w"),
        dtype=jnp.float64)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    batch = _batch(np.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "jnp", _Float64Numpy())
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        (loss_j, _), grads_j = fn(v["params"], v["batch_stats"],
                                  {k: jnp.asarray(a) for k, a in batch.items()})
    grads_j = {k: t for k, t in from_flax({"params": jax.tree.map(np.asarray, grads_j)},
                                          np.float64).items()
               if not k.endswith("num_batches_tracked")}
    return {"jax": (float(loss_j), grads_j), "port": _port_step(batch),
            "nudged": _port_step(_batch(np.float64, 1.0 + 1e-13))}


def test_learned_scale_float64_loss_matches_jax(steps):
    got, ref = steps["port"][0], steps["jax"][0]
    assert np.isfinite(ref) and abs(got - ref) <= 1e-12 * abs(ref)


def test_learned_scale_float64_gradients_match_jax_within_the_envelope(steps):
    grads, ref = steps["port"][1], steps["jax"][1]
    assert set(ref) == set(grads)
    assert any(k.startswith("scaler_func.") for k in ref)
    envelope = max(1e3 * _worst_leaf(steps["nudged"][1], grads), 1e-9)
    worst = _worst_leaf(grads, ref)
    assert worst <= envelope, (worst, envelope)
    assert all(g.abs().max() > 0 for g in ref.values())
