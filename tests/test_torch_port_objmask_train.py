"""PyTorch port vs the JAX package: one masked training step of the
``feature`` preset (the object's relative motion, MovingObjects3D's loss).

B=2 at 32x40 on ``synthetic_batch``'s smooth scene (seed 3, that of
``tests/test_torch_port_train_jax.py``) with the object masks of
``tests/test_torch_port_objmask.py``; the port's seeded weights (seed 7)
carried to flax by ``convert_state_dict``.  Both packages pass the masks to
the tracker and leave the pixels outside the frame-0 object out of the
EPE3D loss.

Tolerances: the loss within 1e-4 relative of the JAX float32 loss; the
BatchNorm running statistics rtol 1e-5 (atol 1e-7 near zero).  Each
gradient leaf within a self-calibrated envelope: 5e-3 of the leaf's
largest JAX entry (the envelope of 12 chained Gauss-Newton solves,
``tests/test_torch_port_train_jax.py``), widened to twice the port's own
float32-to-float64 gap on that leaf where rounding alone moves it further.
The step launches K2, K3 and K6 12 times each, as unmasked: the mask is the
C=11 operand's last channel, whose cotangent is zero.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.kernels import jtj as kjtj
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_objmask import object_masks  # noqa: E402

torch.set_num_threads(2)

B, H, W = 2, 32, 40


def _batch():
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=3, device="cpu").items()}
    batch["obj_mask0"], batch["obj_mask1"] = object_masks(B, H, W)
    return batch


def _port_step(port, batch, dtype=torch.float32):
    port.train()
    loss = tt.compute_loss(port, tt.TrainConfig(), {
        k: torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
        for k, a in batch.items()})
    loss.backward()
    return loss.item(), {k: p.grad.float() for k, p in port.named_parameters()}


@pytest.fixture(scope="module")
def step():
    batch = _batch()
    port = LeastSquareTracking(get_preset("feature")).reset_parameters(7)
    port64 = LeastSquareTracking(get_preset("feature"), plain_kernels=True).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    net = JaxTracker(cfg=jp.get_preset("feature"))
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")  # the unrolled loop's gradients, faster
        (loss_j, stats_j), grads_j = fn(v["params"], v["batch_stats"],
                                        {k: jnp.asarray(a) for k, a in batch.items()})
        for mod, name in ((tw, "gather_twohot"), (tw, "gather_twohot_grads"),
                          (tw, "splat_twohot"), (kjtj, "fused_jtj_jtr")):
            def call(*a, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            mp.setattr(mod, name, call)
        loss_t, grads_t = _port_step(port, batch)
    _, grads_64 = _port_step(port64.double(), batch, torch.float64)
    unmasked = {k: a for k, a in batch.items() if not k.startswith("obj_mask")}
    loss_u, _ = _port_step(LeastSquareTracking(get_preset("feature")).reset_parameters(7),
                           unmasked)
    return {"loss": (loss_t, float(loss_j), loss_u),
            "grads": (grads_t, from_flax({"params": jax.tree.map(np.asarray, grads_j)}),
                      grads_64),
            "stats": (port.state_dict(), from_flax({"batch_stats": jax.tree.map(
                np.asarray, stats_j)})),
            "calls": calls}


def test_masked_loss_matches_jax(step):
    got, ref, unmasked = step["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)
    assert abs(got - unmasked) > 1e-2 * abs(ref)  # the masks change the loss


def test_masked_gradients_match_jax(step):
    got, ref, f64 = step["grads"]
    assert set(got) == set(ref) == set(f64) and len(ref) == 79
    for key, r in ref.items():
        r, g = r.numpy(), got[key].numpy()
        rounding = np.abs(g - f64[key].numpy()).max()
        envelope = max(5e-3 * max(np.abs(r).max(), 1e-12), 2 * rounding)
        np.testing.assert_allclose(g, r, rtol=0, atol=envelope, err_msg=key)


def test_masked_batchnorm_statistics_match_flax(step):
    got, ref = step["stats"]
    stat_keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 46
    for key in stat_keys:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_masked_step_launches_as_unmasked(step):
    """K2 and K6 once an iteration, K3 once an iteration in the backward:
    the C=11 operand holds the mask, whose cotangent is zero."""
    assert step["calls"] == {"gather_twohot_grads": 12, "splat_twohot": 12,
                             "fused_jtj_jtr": 12}
