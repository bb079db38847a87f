"""The training mode ``bf16_residuals`` against the JAX package: one
``feature`` step at 32x40 B=2 with all three training modes against the
JAX step under ``DPFT_BF16_RESIDUALS=1`` and ``DPFT_TRAIN_LOOP=scan_remat``:
the loss within 1e-4 relative, each gradient leaf within 5e-3 of its
largest JAX entry, ``tests/test_torch_port_train.py``'s envelope.  The
maps, the warp and the trained gathers are held in
``tests/test_torch_port_bf16_residuals.py``.
"""
import copy

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
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def jax_bf16_step():
    """The JAX package's ``feature`` loss and gradients under
    ``DPFT_BF16_RESIDUALS=1`` (its loop under ``scan_remat``), and the batch
    and weights it ran on."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(2, 32, 40, seed=3, device="cpu").items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DPFT_BF16_RESIDUALS", "1")
        mp.setenv("DPFT_TRAIN_LOOP", "scan_remat")
        mp.delenv("DPFT_REMAT_ENCODER", raising=False)
        net = JaxTracker(cfg=jp.get_preset("feature"))
        ins = [jnp.asarray(batch[k]) for k in ("color0", "color1", "depth0", "depth1", "calib")]
        v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
        fn = jax.jit(jax.value_and_grad(
            lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
        (loss, _), grads = fn(v["params"], v["batch_stats"],
                              {k: jnp.asarray(a) for k, a in batch.items()})
    return {"batch": batch, "variables": jax.tree.map(np.asarray, dict(v)), "loss": float(loss),
            "grads": from_flax({"params": jax.tree.map(np.asarray, grads)})}


def test_bf16_step_matches_the_jax_bf16_step(jax_bf16_step):
    ref = jax_bf16_step
    net = LeastSquareTracking(get_preset("feature"), remat_gn=True, remat_encoder=True,
                              bf16_residuals=True)
    net.load_state_dict(from_flax(copy.deepcopy(ref["variables"])), strict=True)
    net.train()
    loss = tt.compute_loss(net, tt.TrainConfig(),
                           {k: torch.from_numpy(a) for k, a in ref["batch"].items()})
    loss.backward()
    assert abs(loss.item() - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert grads.keys() == ref["grads"].keys()
    for key, r in ref["grads"].items():
        r = r.numpy()
        np.testing.assert_allclose(grads[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)
