"""PyTorch port vs the JAX package: the eval forwards of the tracker
options, through ``from_flax``.

The one-view ``ConvRGBD`` encoder, the ``dense_net`` initial pose,
``SFMPoseNet`` with ``multi_hypo`` ``average`` / ``None`` and
``res_input``, ``DeepIC`` with ``no_weight_sharing``, ``feature_icp`` with
a learned ICP scale (and ``expMultiScale`` a level), and a predicted pose
over the grayscale encoder; ``compute_residual`` and ``track_diagnostics``
with a learned scale.

Weights and inputs as in ``tests/test_torch_port_variants.py``.  Tolerance:
1e-4 on poses (the acceptance bound; measured within 2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from tests.test_torch_port_variants import B, POSE_ATOL, SCALE, _close, _inputs, _pair

torch.set_num_threads(2)


FORWARDS = [  # (preset, overrides)
    ("feature", ("encoder_name=ConvRGBD",)),
    ("feature", ("init_pose_type=dense_net",)),
    ("feature", ("multi_hypo=average", "res_input=1")),
    ("feature", ("multi_hypo=None",)),
    ("DeepIC", ("no_weight_sharing=1",)),
    ("feature_icp", SCALE),
    ("feature_icp", ("scaler=expMultiScale", "no_weight_sharing=1")),
    ("RGB", ("init_pose_type=sfm_net", "train_init_pose=1")),
]


@pytest.mark.parametrize("preset,overrides", FORWARDS)
def test_eval_forward_matches_jax(preset, overrides):
    port, net, v = _pair(preset, overrides)
    ins = _inputs()
    Rj, tj_ = jax.jit(lambda v, *a: net.apply(v, *a, train=False))(v, *map(jnp.asarray, ins))
    with torch.inference_mode():
        R, t = port(*map(torch.from_numpy, ins))
    _close(R, Rj, POSE_ATOL)
    _close(t, tj_, POSE_ATOL)
    # the predicted pose moved the start: not the identity forward
    if port.cfg.predicts_init_pose:
        with torch.inference_mode():
            pose = port._preprocess(*map(torch.from_numpy, ins[:4]))[-1]
        assert (pose[1].abs() > 0).any()


@pytest.mark.parametrize("level", [0, 3])
def test_compute_residual_with_a_learned_scale(level):
    port, net, v = _pair("feature_icp", SCALE)
    ins = _inputs()
    rng = np.random.RandomState(9)
    R = np.asarray(jax.jit(lambda w: jax.scipy.linalg.expm(
        jnp.cross(jnp.eye(3), w)))(jnp.asarray(rng.randn(3) * 0.02)), np.float32)
    R = np.tile(R, (B, 1, 1))
    t = (rng.randn(B, 3) * 0.02).astype(np.float32)
    fn = jax.jit(lambda v, R, t, *a: net.apply(v, *a, pose_init=(R, t), level=level,
                                               method=JaxTracker.compute_residual))
    _, ref = fn(v, jnp.asarray(R), jnp.asarray(t), *map(jnp.asarray, ins))
    with torch.inference_mode():
        _, got = port.compute_residual(*map(torch.from_numpy, ins),
                                       pose_init=(torch.from_numpy(R), torch.from_numpy(t)),
                                       level=level)
        _, constant = LeastSquareTracking(get_preset("feature_icp")).reset_parameters(3) \
            .compute_residual(*map(torch.from_numpy, ins),
                              pose_init=(torch.from_numpy(R), torch.from_numpy(t)),
                              level=level)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    assert (got - constant).abs().max() > 1e-7  # the learned scale weighs the ICP term


def test_track_diagnostics_with_a_learned_scale():
    port, net, v = _pair("feature_icp", SCALE)
    ins = _inputs()
    (Rj, tj_), ref = jax.jit(lambda v, *a: net.apply(v, *a, method="track_diagnostics"))(
        v, *map(jnp.asarray, ins))
    with torch.inference_mode():
        (R, t), got = port.track_diagnostics(*map(torch.from_numpy, ins))
    _close(R, Rj, POSE_ATOL)
    _close(t, tj_, POSE_ATOL)
    for level in range(4):
        for a, b in zip(got["poses"][level], ref["poses"][level]):
            _close(a, b, POSE_ATOL)
        np.testing.assert_array_equal(got["invalid"][level].numpy(),
                                      np.asarray(ref["invalid"][level]))
        np.testing.assert_allclose(got["residual"][level].numpy(),
                                   np.asarray(ref["residual"][level]), atol=1e-4, rtol=1e-4)


