"""PyTorch port vs the JAX package: the encoder's feature heads and sigma
types, their weight bridge and the U_FC forward with the non-broadcast
``feature`` sigma (a C=49 warp operand), on the CPU.  The sigma slimming is
held in ``tests/test_torch_port_heads_slim.py``.

Each head is held against the JAX ``FeaturePyramid`` with its flax
``PRNGKey(0)`` init carried over by ``from_flax``, as
``tests/test_config_variants.py`` parametrizes them, on a [1,8,16,20]
input: features and sigmas within 1e-5 of their largest entry.  The
``feature`` sigma forward is chaotic in float32 at an untrained init (its
sigma is a conv block's ELU, near zero in places: the port's own float32
and float64 poses differ by 2.8e-3 on the golden inputs), so it is held in
float64, the port's plain path against the JAX package's float64 forward,
within ``F64_ATOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models import presets as tp
from deep_prob_feature_track_torch.models.encoder import FeaturePyramid
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.layers import XavierConv2d
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_tpu.models import encoder as jenc
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models import tracker as jtracker
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker

torch.set_num_threads(2)

B, H, W = 2, 32, 40
FEATURE_SIGMA = ["direction=forward", "uncertainty_type=feature"]
# max |dR|, |dt| of the port's float64 plain forward against the JAX float64
# forward with the feature sigma, measured on the golden inputs on the CPU:
# 6.9e-12 / 2.4e-11
F64_ATOL = 1e-9


def _golden_inputs():
    rng = np.random.RandomState(42)
    return (
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32),
    )


def _pyramids(**kw):
    """(flax variables of a JAX ``FeaturePyramid`` under ``encoder``, the
    port's pyramid loaded with them, the input, the JAX outputs)."""
    x = np.random.RandomState(0).randn(1, 8, 16, 20).astype(np.float32)
    net = jenc.FeaturePyramid(**kw)
    v = net.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = {c: {"encoder": jax.tree.map(np.asarray, dict(v[c]))} for c in v}
    port = FeaturePyramid(in_channels=8, **kw).eval()
    state = from_flax(v)
    port.load_state_dict({k[len("encoder."):]: t for k, t in state.items()}, strict=True)
    ref = net.apply({c: t["encoder"] for c, t in v.items()}, jnp.asarray(x), train=False)
    return v, port, x, ref


def _check_outputs(port, x, ref):
    with torch.no_grad():
        feats, sigmas, raw = port(torch.from_numpy(x))
    for got, want in ((feats, ref[0]), (sigmas, ref[1]), (raw, ref[2])):
        assert len(got) == len(want) == 4
        for g, r in zip(got, want):
            if r is None:
                assert g is None
                continue
            r = np.asarray(r)
            assert g.shape == r.shape, (g.shape, r.shape)
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    return feats, sigmas


def _convert_back(port, v):
    """The JAX package's own bridge takes the port's weights back to the
    flax tree they came from, leaf for leaf, with nothing unmapped."""
    back = convert_state_dict({f"encoder.{k}": t for k, t in port.state_dict().items()})
    assert back.pop("unmapped") == {}
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("feature_extract", ["conv", "1by1", "average", "skip", "prob_fuse"])
def test_feature_heads_match_flax(feature_extract):
    fc = 1 if feature_extract in ("average", "prob_fuse") else 4
    v, port, x, ref = _pyramids(feature_channel=fc, uncertainty_channel=1,
                                feature_extract=feature_extract, uncertainty_type="laplacian")
    feats, sigmas = _check_outputs(port, x, ref)
    expect_c = {"conv": fc, "1by1": fc, "average": 1, "prob_fuse": 1, "skip": 32}
    assert feats[0].shape[1] == expect_c[feature_extract]
    assert sigmas[0].shape == feats[0].shape  # the sigma is repeated to every channel
    heads = {"conv": "ConvBlock", "prob_fuse": "ConvBlock", "1by1": "XavierConv2d"}
    f_conv = getattr(port, "f_conv0", None)
    assert (type(f_conv).__name__ if f_conv is not None else None) == heads.get(feature_extract)
    if feature_extract == "prob_fuse":
        assert f_conv[0].out_channels == 16  # 8 features, 8 gates
    _convert_back(port, v)


@pytest.mark.parametrize("uncertainty_type", ["identity", "sigmoid", "gaussian", "laplacian",
                                              "old_gaussian", "old_laplacian", "feature"])
def test_sigma_types_match_flax(uncertainty_type):
    channel = 4 if uncertainty_type == "feature" else 1
    v, port, x, ref = _pyramids(feature_channel=4, uncertainty_channel=channel,
                                feature_extract="conv", uncertainty_type=uncertainty_type)
    _, sigmas = _check_outputs(port, x, ref)
    s = sigmas[0].numpy()
    assert s.shape[1] == 4 and np.isfinite(s).all()
    if uncertainty_type in ("gaussian", "laplacian", "old_gaussian", "old_laplacian"):
        assert (s > 0).all()
    if uncertainty_type == "sigmoid":
        assert ((s >= 0) & (s <= 1)).all()
    if uncertainty_type == "identity":
        assert (s == 1).all() and not any(k.startswith("sigma_conv") for k in port.state_dict())
    if uncertainty_type == "feature":
        # one conv block of feature_channel outputs, used as it is: ELU,
        # negative in places, not repeated from one channel
        assert (s < 0).any() and not np.allclose(s[:, :1], s[:, 1:])
        assert set(k.split(".")[1] for k in port.state_dict() if k.startswith("sigma_conv0")) \
            == {"0", "1"}
        # the JAX package's bridge reads sigma_conv{i}.1.weight (this head's
        # BatchNorm scale) as the two-part head's final conv and cannot
        # take this head back: from_flax reads the head's kind from the tree
        assert "encoder.sigma_conv0.1.running_var" in from_flax(v)
    else:
        _convert_back(port, v)


def test_from_flax_reads_the_sigma_head_from_the_tree():
    """Both sigma heads are ``s_heads_{i}_0`` in flax: a tree with
    ``params`` tells them apart by the second part, ``s_heads_{i}_1``."""
    two_part = _pyramids(feature_channel=4, uncertainty_type="laplacian")[0]
    one_part = _pyramids(feature_channel=4, uncertainty_channel=4,
                         uncertainty_type="feature")[0]
    assert "encoder.sigma_conv0.0.0.weight" in from_flax(two_part)
    assert "encoder.sigma_conv0.1.weight" in from_flax(two_part)
    assert "encoder.sigma_conv0.0.weight" in from_flax(one_part)
    assert "encoder.sigma_conv0.1.running_mean" in from_flax(one_part)
    stats = from_flax({"batch_stats": two_part["batch_stats"]})
    assert "encoder.sigma_conv0.0.1.running_mean" in stats


def test_seeded_init_draws_the_1by1_head_xavier_uniform():
    """The ``1by1`` head's kernels are uniform within the xavier bound (not
    the lecun-normal of the other plain convs), its biases zero, all from
    the seed."""
    cfg = tp.apply_overrides(tp.get_preset("feature"), ["feature_extract=1by1"])
    a = LeastSquareTracking(cfg).reset_parameters(3).state_dict()
    torch.manual_seed(1)
    b = LeastSquareTracking(cfg).reset_parameters(3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    net = LeastSquareTracking(cfg)
    for i, c in enumerate((32, 64, 96, 128)):
        assert isinstance(getattr(net.encoder, f"f_conv{i}"), XavierConv2d)
        w = a[f"encoder.f_conv{i}.weight"]
        assert w.shape == (8, c, 1, 1)
        bound = np.sqrt(6.0 / (c + 8))
        assert w.abs().max() <= bound
        # a uniform kernel puts a fifth of its entries above 0.8 of the
        # bound; lecun-normal (truncated at 2 std) puts 5% there at c=128
        assert 0.12 < (w.abs() > 0.8 * bound).float().mean() < 0.3
        assert torch.equal(a[f"encoder.f_conv{i}.bias"], torch.zeros(8))


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is float64: the JAX tracker casts the
    encoder's outputs to ``jnp.float32`` for the solve, and a float64 run
    must keep them in float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_feature_sigma_ufc_forward_matches_jax_in_float64(monkeypatch):
    """The U_FC forward with the ``feature`` sigma: its operand is C=49
    (depth 1, features 8, sigma 8, and the gradients of both, 16 each),
    one K1 call an iteration; the port's float64 plain forward equals the
    JAX float64 forward within ``F64_ATOL`` (measured 6.9e-12 / 2.4e-11 on
    R / t), and its float32 forward is finite and orthonormal."""
    cfg_j = jp.apply_overrides(jp.get_preset("feature"), FEATURE_SIGMA)
    net = JaxTracker(cfg=cfg_j)
    ins = _golden_inputs()
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7),
                                                            *map(jnp.asarray, ins))
    v = jax.tree.map(np.asarray, dict(v))
    cfg = tp.apply_overrides(tp.get_preset("feature"), FEATURE_SIGMA)
    port = LeastSquareTracking(cfg)
    port.load_state_dict(from_flax(v), strict=True)
    port64 = LeastSquareTracking(cfg, plain_kernels=True)
    port64.load_state_dict(from_flax(v), strict=True)
    port64.double()

    channels = []
    sample = tw.gather_twohot
    monkeypatch.setattr(tw, "gather_twohot",
                        lambda F, *a: channels.append(F.shape[-1]) or sample(F, *a))
    with torch.inference_mode():
        R, t = port(*map(torch.from_numpy, ins))
    assert channels == [49] * 12
    assert torch.isfinite(t).all()
    assert (R.transpose(1, 2) @ R - torch.eye(3)).abs().max() < 1e-5
    with torch.inference_mode():
        R64, t64 = port64(*[torch.from_numpy(a.astype(np.float64)) for a in ins])

    net64 = JaxTracker(cfg=cfg_j, dtype=jnp.float64)
    monkeypatch.setattr(jtracker, "jnp", _Float64Numpy())
    Rj, tj = jax.jit(lambda v, *a: net64.apply(v, *a, train=False))(
        jax.tree.map(lambda a: np.asarray(a, np.float64), v),
        *[jnp.asarray(a, jnp.float64) for a in ins])
    assert np.asarray(tj).dtype == np.float64
    np.testing.assert_allclose(R64.numpy(), np.asarray(Rj), rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(t64.numpy(), np.asarray(tj), rtol=0, atol=F64_ATOL)
    assert not np.allclose(np.asarray(tj), 0.0, atol=1e-3)
