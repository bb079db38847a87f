"""PyTorch port vs the JAX package: the classical presets ``RGB``
(grayscale IC), ``ICP`` (point-to-plane ICP) and ``RGB+ICP`` (grayscale
U_IC with the fused ICP term), evaluated and served on the CPU.

They have no weights; inputs are those of ``tests/test_golden.py``, and the
solve starts from the identity pose, as in the presets.  Tolerances: atol
1e-4 on R and t against the JAX forward (the acceptance bound) and 2e-5
against the golden file (its own bound, tests/test_golden.py; ``RGB+ICP``
has no golden entry).
"""

import dataclasses

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
PRESETS = ["RGB", "ICP", "RGB+ICP"]
KEYS = ("color0", "color1", "depth0", "depth1", "calib")


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
def jax_poses():
    """The JAX forward of each preset, jitted once: the classical presets
    have no variables, so ``apply`` takes the empty tree."""
    poses = {}
    for preset in PRESETS:
        net = JaxTracker(cfg=jp.get_preset(preset))
        R, t = jax.jit(lambda *a: net.apply({}, *a, train=False))(
            *map(jnp.asarray, _golden_inputs()))
        poses[preset] = np.asarray(R), np.asarray(t)
    return poses


def _port_pose(preset, train=False):
    net = LeastSquareTracking(get_preset(preset))
    with torch.inference_mode():
        return net.train(train)(*map(torch.from_numpy, _golden_inputs()))


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_matches_jax(jax_poses, preset):
    Rj, tj = jax_poses[preset]
    R, t = _port_pose(preset)
    np.testing.assert_allclose(R.numpy(), Rj, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), tj, atol=1e-4)
    assert not np.allclose(t.numpy(), 0.0, atol=1e-4)  # the solve moved off the identity


@pytest.mark.parametrize("preset", ["RGB", "ICP"])
def test_forward_matches_golden(preset):
    golden = np.load(GOLDEN)
    R, t = _port_pose(preset)
    np.testing.assert_allclose(R.numpy(), golden[f"{preset}_R"], atol=2e-5)
    np.testing.assert_allclose(t.numpy(), golden[f"{preset}_t"], atol=2e-5)


def test_from_flax_takes_the_empty_variables():
    """The classical presets have an empty variable tree and no weights;
    ``DeepIC`` with an M-estimator and a damping net per level has one of
    each a level, and a predicted initial pose over the grayscale encoder
    reads the 1-channel pyramid of both frames."""
    sds = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in _golden_inputs()]
    for preset in PRESETS:
        net = JaxTracker(cfg=jp.get_preset(preset))
        # the variables' structure, traced without compiling
        v = jax.eval_shape(lambda k, *a: net.init(k, *a, train=False),
                           jax.random.PRNGKey(7), *sds)
        port = LeastSquareTracking(get_preset(preset))
        assert jax.tree.leaves(v) == []
        port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
        assert port.state_dict() == {}
        assert port.reset_parameters(3) is port  # nothing to seed
    levels = LeastSquareTracking(dataclasses.replace(get_preset("DeepIC"), no_weight_sharing=True))
    assert {k.split(".")[0] for k in levels.state_dict() if "_func" in k} == {
        f"{name}{i}" for name in ("mEst_func", "solver_func") for i in range(4)}
    gray = LeastSquareTracking(dataclasses.replace(get_preset("RGB"), init_pose_type="sfm_net"))
    assert gray.pose_predictor.net[0][0].in_channels == 2


@pytest.mark.parametrize("preset", PRESETS)
def test_build_and_serve_on_cpu(preset):
    """``build_tracker`` and ``build_service`` take a preset without
    weights; a served request gets the direct forward's pose of a batch
    padded with copies of it."""
    assert not build_tracker(preset, device="cpu").training
    svc = build_service(preset, "", max_batch=2, H=H, W=W, device="cpu", batch_timeout_ms=1.0)
    try:
        ins = _golden_inputs()
        out = svc.submit({k: a[0] for k, a in zip(KEYS, ins)}, timeout=120)
    finally:
        svc.stop()
    with torch.inference_mode():
        R, t = build_tracker(preset, device="cpu")(
            *[torch.from_numpy(np.stack([a[0], a[0]])) for a in ins])
    np.testing.assert_allclose(out["R"], R[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(out["t"], t[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("preset", PRESETS)
def test_training_forward_returns_the_four_level_poses(preset):
    """Without a predicted initial pose the training forward returns the
    pose after each of the four levels; without weights or BatchNorm its
    last pose is the eval forward's."""
    pyr_R, pyr_t = _port_pose(preset, train=True)
    R, t = _port_pose(preset)
    assert pyr_R.shape == (B, 4, 3, 3) and pyr_t.shape == (B, 4, 3)
    torch.testing.assert_close(pyr_R[:, -1], R, rtol=0, atol=0)
    torch.testing.assert_close(pyr_t[:, -1], t, rtol=0, atol=0)
