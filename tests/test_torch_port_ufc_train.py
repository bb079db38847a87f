"""PyTorch port vs the JAX package: one training loss and backward of the
forward-compositional U_FC track (``feature`` with ``direction=forward``)
on the CPU.

B=2 at 64x80 on ``synthetic_batch`` seed 5, with the port's seeded weights
(seed 7) carried to flax by the JAX package's ``convert_state_dict``.  At
32x40 the U_FC step is chaotic in float32 in both packages: its level 3 is
4x5 pixels, the port's own float32 and float64 steps differ by 7.7e-2 of
the largest entry of the worst gradient leaf, and the JAX package's
scanned and unrolled loops by 3.7e-4 relative on the loss.  At 64x80 the
port's float32 and float64 steps agree within 1.5e-3 on every leaf, for
each of the seeds 1, 3, 5 and 7 (the learned estimator's step:
``tests/test_torch_port_ufc_mest_train.py``).

Tolerances, against the JAX float32 loss: the loss within 1e-4 relative;
each gradient leaf within 5e-3 of its largest JAX entry, the envelope of
12 chained Gauss-Newton solves (``tests/test_torch_port_train_jax.py``); the
BatchNorm running statistics within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models import presets as tp
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

B, H, W = 2, 64, 80
UFC = ["direction=forward"]
KERNELS = ("gather_twohot", "gather_twohot_grads", "splat_twohot", "gather_tiles",
           "gather_tiles_grads")


@pytest.fixture(scope="module")
def step():
    """The port's loss, gradients, statistics and kernel calls of one
    training batch, and the JAX loss, statistics and gradients from the same
    weights."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=5, device="cpu").items()}
    cfg = tp.apply_overrides(tp.get_preset("feature"), UFC)
    port = LeastSquareTracking(cfg).reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    net = JaxTracker(cfg=jp.apply_overrides(jp.get_preset("feature"), UFC))
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's scanned, rematerialized GN loop: the unrolled
        # loop's gradients (tests/test_training.py), in less compile time
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        (loss_j, stats_j), grads_j = fn(v["params"], v["batch_stats"],
                                        {k: jnp.asarray(a) for k, a in batch.items()})
        for name in KERNELS:
            def call(*a, _fn=getattr(tw, name), _name=name):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a)
            mp.setattr(tw, name, call)
        port.train()
        loss_t = tt.compute_loss(port, tt.TrainConfig(), {k: torch.from_numpy(a)
                                                          for k, a in batch.items()})
        loss_t.backward()
    return {
        "loss": (loss_t.item(), float(loss_j)),
        "grads": ({k: p.grad for k, p in port.named_parameters()},
                  from_flax({"params": jax.tree.map(np.asarray, grads_j)})),
        "stats": (port.state_dict(), from_flax({"batch_stats": jax.tree.map(np.asarray,
                                                                            stats_j)})),
        "calls": calls,
    }


def test_loss_matches_jax(step):
    got, ref = step["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_loss_gradients_match_jax(step):
    got, ref = step["grads"]
    assert set(got) == set(ref) and len(ref) == 79  # feature's leaves
    for key, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)


def test_batchnorm_running_stats_match_flax(step):
    got, ref = step["stats"]
    stat_keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 46
    for key in stat_keys:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_training_step_gathers_as_pinned(step):
    """The step samples its C=28 operand through K2's wrapper once an
    iteration (the grads tile gate refuses Cp > 16) and splats its
    cotangent through K3's; no K1, K4 or K5."""
    assert step["calls"] == {"gather_twohot_grads": 12, "splat_twohot": 12}
