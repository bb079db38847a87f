"""PyTorch port vs the JAX package: one training loss and backward of the
``feature_icp`` preset on the CPU.

B=2 at 32x40 on ``synthetic_batch`` seed 5, with the port's seeded weights
(seed 7) carried to flax by the JAX package's ``convert_state_dict``.
Tolerances: the loss within 1e-4 relative of the JAX loss; each gradient leaf within 5e-3 of the leaf's
largest JAX entry, the envelope of 12 chained Gauss-Newton solves that
``tests/test_torch_port_train_jax.py`` holds the ``feature`` preset to.
"""

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
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

B, H, W = 2, 32, 40


@pytest.fixture(scope="module")
def loss_and_grads():
    """JAX and port loss and parameter gradients of one training batch,
    from the same weights."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=5, device="cpu").items()}
    port = LeastSquareTracking(get_preset("feature_icp")).reset_parameters(7)
    # the JAX package's own bridge carries the port's weights over: no
    # flax init to compile (tests/test_torch_port_models.py holds it)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    net = JaxTracker(cfg=jp.get_preset("feature_icp"))
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's scanned, rematerialized GN loop: the unrolled
        # loop's gradients (tests/test_training.py), in 2/3 of its compile
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        (loss_j, _), grads_j = fn(v["params"], v["batch_stats"],
                                  {k: jnp.asarray(a) for k, a in batch.items()})
    port.train()
    loss_t = tt.compute_loss(port, tt.TrainConfig(), {k: torch.from_numpy(a)
                                                      for k, a in batch.items()})
    loss_t.backward()
    return {
        "loss": (loss_t.detach().item(), float(loss_j)),
        "grads": ({k: p.grad for k, p in port.named_parameters()},
                  from_flax({"params": jax.tree.map(np.asarray, grads_j)})),
    }


def test_loss_matches_jax(loss_and_grads):
    got, ref = loss_and_grads["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_loss_gradients_match_jax(loss_and_grads):
    got, ref = loss_and_grads["grads"]
    assert set(got) == set(ref) and len(ref) == 79
    for key, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)
