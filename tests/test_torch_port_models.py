"""PyTorch port vs the JAX package: the feature preset's networks and the
weight bridge.

The flax ``PRNGKey(7)`` init of the feature preset, with its BatchNorm
statistics and affine parameters and its conv biases replaced by random
values (the init's mean 0 / var 1 / scale 1 / bias 0 would leave them
untested), is carried into the port by ``from_flax``.  Encoder and pose
net outputs are compared at B=2, 32x40 with rtol 1e-4, atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.encoder import FeaturePyramid
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker

torch.set_num_threads(2)

B, H, W = 2, 32, 40
N_LEAVES, N_VALUES = 125, 1_836_532


def _inputs(seed=42):
    rng = np.random.RandomState(seed)
    return (
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32),
    )


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


@pytest.fixture(scope="module")
def flax_model():
    """(JAX tracker, numpy variables with randomized BN and biases)."""
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(a) for a in _inputs()]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    v = jax.tree.map(lambda x: np.array(x, dtype=np.float32), dict(v))
    rng = np.random.RandomState(3)
    for coll in ("params", "batch_stats"):
        for path, x in list(_leaves(v[coll])):
            if path[-1] in ("mean", "bias"):
                _set(v[coll], path, (rng.randn(*x.shape) * 0.1).astype(np.float32))
            elif path[-1] in ("var", "scale"):
                _set(v[coll], path, rng.uniform(0.5, 1.5, x.shape).astype(np.float32))
    return net, v


@pytest.fixture(scope="module")
def port_model(flax_model):
    m = LeastSquareTracking(get_preset("feature"))
    m.load_state_dict(from_flax(flax_model[1]), strict=True)
    return m


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_from_flax_maps_every_leaf(flax_model):
    _, v = flax_model
    leaves = list(_leaves(v["params"])) + list(_leaves(v["batch_stats"]))
    assert len(leaves) == N_LEAVES
    assert sum(x.size for _, x in leaves) == N_VALUES
    state = from_flax(v)
    weights = {k: t for k, t in state.items() if not k.endswith("num_batches_tracked")}
    assert len(weights) == N_LEAVES
    assert sum(t.numel() for t in weights.values()) == N_VALUES
    assert set(state) == set(LeastSquareTracking(get_preset("feature")).state_dict())


def test_from_flax_then_convert_state_dict_is_identity(flax_model):
    _, v = flax_model
    back = convert_state_dict(from_flax(v))
    assert back["unmapped"] == {}
    for coll in ("params", "batch_stats"):
        got = dict(_leaves(back[coll]))
        ref = dict(_leaves(v[coll]))
        assert got.keys() == ref.keys()
        for path in ref:
            np.testing.assert_array_equal(got[path], ref[path], err_msg=str(path))


def test_port_state_dict_converts_to_flax_variables(flax_model, port_model):
    _, v = flax_model
    back = convert_state_dict(port_model.state_dict())
    assert back["unmapped"] == {}
    for coll in ("params", "batch_stats"):
        ref = dict(_leaves(v[coll]))
        got = dict(_leaves(back[coll]))
        assert got.keys() == ref.keys()
        for path in ref:
            np.testing.assert_array_equal(got[path], ref[path], err_msg=str(path))


def test_from_flax_rejects_unknown_leaf(flax_model):
    v = {"params": {"encoder": {"mystery": {"kernel": np.zeros((1, 1, 1, 1))}}}}
    with pytest.raises(KeyError, match="mystery"):
        from_flax(v)


def test_feature_pyramid_matches_flax(flax_model, port_model):
    net, v = flax_model
    rng = np.random.RandomState(0)
    x = rng.randn(B, 8, H, W).astype(np.float32)
    ref = jax.jit(lambda v, a: net.apply(v, a, method=lambda m, a: m.encoder(a, False)))(
        v, jnp.asarray(x))
    with torch.inference_mode():
        got = port_model.encoder(torch.from_numpy(x))
    for g_list, r_list in zip(got, ref):
        assert len(g_list) == len(r_list) == 4
        for g, r in zip(g_list, r_list):
            assert tuple(g.shape) == r.shape
            _close(g, r)


def test_sfm_pose_net_matches_flax(flax_model, port_model):
    net, v = flax_model
    rng = np.random.RandomState(1)
    x0 = rng.randn(B, 128, H // 8, W // 8).astype(np.float32)
    x1 = rng.randn(B, 128, H // 8, W // 8).astype(np.float32)
    R, t = net.apply(v, jnp.asarray(x0), jnp.asarray(x1),
                     method=lambda m, a, b: m.pose_predictor(a, b, train=False))
    with torch.inference_mode():
        Rt, tt = port_model.pose_predictor(torch.from_numpy(x0), torch.from_numpy(x1))
    _close(Rt, R)
    _close(tt, t)


def test_seeded_init_is_deterministic():
    a = LeastSquareTracking(get_preset("feature")).reset_parameters(5).state_dict()
    b = LeastSquareTracking(get_preset("feature")).reset_parameters(5).state_dict()
    c = LeastSquareTracking(get_preset("feature")).reset_parameters(6).state_dict()
    key = "encoder.net0.0.0.weight"
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a[key], c[key])
    # xavier-uniform bound of a 3x3 conv 8 -> 16
    bound = np.sqrt(6.0 / (9 * 8 + 9 * 16))
    assert a[key].abs().max() <= bound
    assert torch.equal(a["encoder.net0.0.1.running_var"], torch.ones(16))


# a preset with an option that was ported last (DeepIC with an M-estimator
# and a damping net per level, feature with the dense_net PoseNet initial
# pose), and with a value that no package knows
UNPORTED = {"DeepIC": ({"no_weight_sharing": True}, {"mest_type": "Tukey"}),
            "feature": ({"init_pose_type": "dense_net"}, {"init_pose_type": "flow_net"})}


@pytest.mark.parametrize("preset", sorted(UNPORTED))
def test_unported_presets_raise(preset):
    ported, unknown = UNPORTED[preset]
    LeastSquareTracking(dataclasses.replace(get_preset(preset), **ported))
    with pytest.raises(ValueError):
        LeastSquareTracking(dataclasses.replace(get_preset(preset), **unknown))


def test_unported_encoder_heads_raise():
    """Every feature head and sigma type of the JAX encoder is ported
    (tests/test_torch_port_heads.py) and an unknown one is refused; so is
    the one-view ConvRGBD encoder (4 input channels), and an unknown
    encoder is refused."""
    with pytest.raises(ValueError):
        FeaturePyramid(feature_extract="prob_fuse2")
    with pytest.raises(ValueError):
        FeaturePyramid(uncertainty_type="ICP")
    one_view = LeastSquareTracking(dataclasses.replace(get_preset("feature"),
                                                       encoder_name="ConvRGBD"))
    assert one_view.encoder.net0[0][0].in_channels == 4
    with pytest.raises(ValueError):
        LeastSquareTracking(dataclasses.replace(get_preset("feature"), encoder_name="ConvRGBD3"))
