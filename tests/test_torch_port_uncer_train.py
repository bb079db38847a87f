"""PyTorch port vs the JAX package: one training step of the ``feature``
preset with ``uncer_prop`` under the URPE and UEPE3D losses.

Both packages run in float64 from the same weights (the port's seeded init
carried over by the JAX package's ``convert_state_dict``) on
``synthetic_batch``'s smooth scene, seed 3, B=2 at 32x40: the loss within
1e-12 relative, and each gradient leaf within a self-calibrated envelope
of its largest entry: 1e3 times the largest change of any leaf (relative
to its largest entry) when the port's own float64 step takes the depth
scaled by 1 + 1e-13, floored at 1e-9 (that change stays under 1e-12, so
the floor holds).  The two packages' leaves sit 7.2e-13 apart at worst.
The JAX loss and gradient compile through the JAX
package's ``DPFT_TRAIN_LOOP=scan_remat`` loop (2/3 of the unrolled loop's
compile time).  The port's float32 step, through the kernels' plain
versions on the CPU, is held to finite values and a nonzero gradient of
every leaf.
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

torch.set_num_threads(2)
B, H, W = 2, 32, 40
UNCER = ["uncer_prop=1"]


def _batch(dtype, depth_scale=1.0):
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=3).items()}
    batch["depth0"] = batch["depth0"] * depth_scale
    return {k: a.astype(dtype) if a.dtype == np.float32 else a for k, a in batch.items()}


def _port_step(loss, batch, float64=True):
    port = LeastSquareTracking(apply_overrides(get_preset("feature"), UNCER),
                               plain_kernels=float64).reset_parameters(7)
    if float64:
        port.double()
    port.train()
    value = tt.compute_loss(port, tt.TrainConfig(loss=loss),
                            {k: torch.from_numpy(a) for k, a in batch.items()})
    value.backward()
    return value.item(), {k: p.grad for k, p in port.named_parameters()}


def _worst_leaf(grads, ref):
    return max(((grads[k] - g).abs().max() / g.abs().max().clamp_min(1e-300)).item()
               for k, g in ref.items())


@pytest.fixture(scope="module", params=["URPE", "UEPE3D"])
def steps(request):
    loss = request.param
    port = LeastSquareTracking(apply_overrides(get_preset("feature"), UNCER)).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    net = jtracker.LeastSquareTracking(
        cfg=dataclasses.replace(jp.get_preset("feature"), uncer_prop=True), dtype=jnp.float64)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(loss=loss), p, s, bb),
        has_aux=True))
    batch = _batch(np.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "jnp", _Float64Numpy())
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        (loss_j, _), grads_j = fn(v["params"], v["batch_stats"],
                                  {k: jnp.asarray(a) for k, a in batch.items()})
    grads_j = {k: t for k, t in from_flax({"params": jax.tree.map(np.asarray, grads_j)},
                                          np.float64).items()
               if not k.endswith("num_batches_tracked")}
    return {"loss": loss, "jax": (float(loss_j), grads_j),
            "port": _port_step(loss, batch),
            "nudged": _port_step(loss, _batch(np.float64, 1.0 + 1e-13))}


def test_float64_loss_matches_jax(steps):
    got, ref = steps["port"][0], steps["jax"][0]
    assert np.isfinite(ref) and abs(got - ref) <= 1e-12 * abs(ref)


def test_float64_gradients_match_jax_within_the_envelope(steps):
    grads, ref = steps["port"][1], steps["jax"][1]
    assert set(ref) == set(grads)
    envelope = max(1e3 * _worst_leaf(steps["nudged"][1], grads), 1e-9)
    worst = _worst_leaf(grads, ref)
    assert worst <= envelope, (worst, envelope)
    assert all(g.abs().max() > 0 for g in ref.values())


def test_float32_step_is_finite(steps):
    value, grads = _port_step(steps["loss"], _batch(np.float32), float64=False)
    assert np.isfinite(value)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads.values())
