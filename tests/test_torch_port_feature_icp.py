"""PyTorch port vs the JAX package: the ``feature_icp`` preset (the paper
model with the fused point-to-plane ICP term) evaluated and served on the
CPU.

Weights are the flax ``PRNGKey(7)`` init carried over by ``from_flax``;
inputs are those of ``tests/test_golden.py``.  Tolerances: atol 1e-4 on R
and t against the JAX forward (the acceptance bound), 2e-5 against the
golden file (its own bound, tests/test_golden.py), and ``PALLAS_ATOL``
against the JAX forward that routes its gathers through the Pallas
interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps.serve import build_service, build_tracker
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker

torch.set_num_threads(2)

B, H, W = 2, 32, 40
GOLDEN = __file__.rsplit("/", 1)[0] + "/golden_forward.npz"
KEYS = ("color0", "color1", "depth0", "depth1", "calib")
# max |dR|, |dt| between the port and the JAX forward through the Pallas
# interpreter (bf16x3 "high" precision), measured on these inputs on the
# CPU: 3.3e-6 / 2.0e-6 (against the XLA gather path: 6.1e-8 / 2.8e-8).
# Bounded at 1e-5, as for ``feature``.
PALLAS_ATOL = 1e-5


def _golden_inputs():
    rng = np.random.RandomState(42)
    return (
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def models():
    """(JAX tracker, its PRNGKey(7) variables, the port tracker with them)."""
    net = JaxTracker(cfg=jp.get_preset("feature_icp"))
    ins = [jnp.asarray(a) for a in _golden_inputs()]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    port = LeastSquareTracking(get_preset("feature_icp"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    return net, v, port


@pytest.fixture(scope="module")
def port_pose(models):
    with torch.inference_mode():
        R, t = models[2](*map(torch.from_numpy, _golden_inputs()))
    return R.numpy(), t.numpy()


def _jax_pose(models):
    """JAX forward, jitted afresh so it traces under the current env."""
    net, v, _ = models
    R, t = jax.jit(lambda v, *a: net.apply(v, *a, train=False))(
        v, *map(jnp.asarray, _golden_inputs()))
    return np.asarray(R), np.asarray(t)


def test_forward_matches_jax(models, port_pose):
    Rj, tj = _jax_pose(models)
    np.testing.assert_allclose(port_pose[0], Rj, atol=1e-4)
    np.testing.assert_allclose(port_pose[1], tj, atol=1e-4)


def test_forward_matches_golden(port_pose):
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(port_pose[0], golden["feature_icp_R"], atol=2e-5)
    np.testing.assert_allclose(port_pose[1], golden["feature_icp_t"], atol=2e-5)


def test_forward_matches_jax_pallas_gather(models, port_pose, monkeypatch):
    monkeypatch.setenv("DPFT_PALLAS_GATHER", "1")
    monkeypatch.setenv("DPFT_PALLAS_INTERPRET", "1")
    Rj, tj = _jax_pose(models)
    np.testing.assert_allclose(port_pose[0], Rj, atol=PALLAS_ATOL)
    np.testing.assert_allclose(port_pose[1], tj, atol=PALLAS_ATOL)


def test_from_flax_maps_the_feature_variables(models):
    """``feature_icp`` has ``feature``'s variables: ``ScaleNet("None")``
    has none."""
    feature = LeastSquareTracking(get_preset("feature")).state_dict()
    assert models[2].state_dict().keys() == feature.keys()
    assert len(jax.tree.leaves(models[1])) == 125


def test_build_and_serve_on_cpu(port_pose):
    """A served request gets the direct forward's pose of a batch padded
    with copies of it; the seeded init is the same for the same seed."""
    svc = build_service("feature_icp", "", max_batch=2, H=H, W=W, device="cpu", seed=4,
                        batch_timeout_ms=1.0)
    try:
        ins = _golden_inputs()
        out = svc.submit({k: a[0] for k, a in zip(KEYS, ins)}, timeout=120)
    finally:
        svc.stop()
    with torch.inference_mode():
        R, t = build_tracker("feature_icp", device="cpu", seed=4)(
            *[torch.from_numpy(np.stack([a[0], a[0]])) for a in ins])
    np.testing.assert_allclose(out["R"], R[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(out["t"], t[0].numpy(), atol=1e-5)
