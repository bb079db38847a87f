"""PyTorch port vs the JAX package: the tracker options' modules.

The learned ``ScaleNet`` types, ``SFMPoseNet`` with ``multi_hypo``
``None`` / ``average`` and ``res_input``, the ``dense_net`` ``PoseNet``,
each against its flax module through ``from_flax``; ``no_weight_sharing``'s
module a level; the learned ICP scale's gathers counted; and every
``TrackerConfig`` value the JAX package accepts.  The eval forwards of the
new options are in ``tests/test_torch_port_variants_forward.py``.

Weights: the port's seeded init carried to the JAX package by its
``convert_state_dict`` (no flax init to compile), or for ``PoseNet``, whose
names the original implementation's checkpoints do not hold, a jitted flax
init carried back by ``from_flax``.  Inputs: seeded numpy arrays at B=2,
32x40.  Tolerances: 1e-4 on poses (the acceptance bound; measured within
2e-7), 1e-5 on module outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models import nets as tn
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking, TrackerConfig
from deep_prob_feature_track_torch.ops.kernels import jtj as kj
from deep_prob_feature_track_torch.solvers import jacobians as tj
from deep_prob_feature_track_tpu.models import nets as jn
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker

torch.set_num_threads(2)
B, H, W = 2, 32, 40
POSE_ATOL = 1e-4
OUT_ATOL = 1e-5
SCALE = ("scaler=MultiScale2w",)


def _inputs(b=B, h=H, w=W, seed=42):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 3, h, w).astype(np.float32), rng.rand(b, 3, h, w).astype(np.float32),
            rng.uniform(0.5, 3.0, (b, 1, h, w)).astype(np.float32),
            rng.uniform(0.5, 3.0, (b, 1, h, w)).astype(np.float32),
            np.tile([[26.0, 26.0, 19.5, 15.5]], (b, 1)).astype(np.float32))


def _close(got, ref, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _load(module, variables, prefix, flax_name):
    """Load a flax module's variables into the port module ``module``,
    through ``from_flax`` under the tracker's name of the module."""
    tree = {c: {flax_name: variables[c]} for c in ("params", "batch_stats") if c in variables}
    state = from_flax(jax.tree.map(np.asarray, tree))
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)
    return module


def _flax_apply(module, variables, *args, train=False):
    fn = jax.jit(lambda v, *a: module.apply(v, *a, train=train, mutable=["batch_stats"]))
    return fn(variables, *args)[0]


@pytest.mark.parametrize("kind", ["oneResidual", "twoResidual", "MultiScale2w",
                                  "expMultiScale"])
def test_scalenet_types_match_flax(kind):
    rng = np.random.RandomState(1)
    icp = rng.randn(B, 1, 8, 10).astype(np.float32)
    feat = rng.randn(B, 8, 8, 10).astype(np.float32)
    w_prior = rng.rand(B, 1, 4, 5).astype(np.float32)
    args = (icp, feat, w_prior)
    flax = jn.ScaleNet(kind, scale=0.5)
    v = jax.jit(lambda k, *a: flax.init(k, *a))(jax.random.PRNGKey(3), *map(jnp.asarray, args))
    port = _load(tn.ScaleNet(kind, scale=0.5), v, "scaler_func.", "scalers_0")
    assert port.learned and [type(m).__name__ for m in port.net] == ["ConvBlock"] * 4 + [
        "Conv2d"]
    for train in (False, True):
        port.train(train)
        got = port(*map(torch.from_numpy, args))
        ref = _flax_apply(flax, v, *map(jnp.asarray, args), train=train)
        assert got.shape == (B, 1, 8, 10)
        _close(got, ref, OUT_ATOL)
    assert not tn.ScaleNet("None").learned
    with pytest.raises(ValueError, match="ScaleNet"):
        tn.ScaleNet("twoResiduals")


@pytest.mark.parametrize("multi_hypo,res_input", [("None", False), ("average", False),
                                                  ("prob_fuse", True), ("None", True)])
def test_sfm_posenet_variants_match_flax(multi_hypo, res_input):
    rng = np.random.RandomState(2)
    x0, x1 = (rng.randn(B, 128, 4, 5).astype(np.float32) for _ in range(2))
    flax = jn.SFMPoseNet(scale_motion=0.3, multi_hypo=multi_hypo, res_input=res_input)
    v = jax.jit(lambda k, *a: flax.init(k, *a))(jax.random.PRNGKey(4), jnp.asarray(x0),
                                                jnp.asarray(x1))
    port = _load(tn.SFMPoseNet((3 if res_input else 2) * 128, scale_motion=0.3,
                               multi_hypo=multi_hypo, res_input=res_input),
                 v, "pose_predictor.", "pose_predictor")
    if multi_hypo == "None":
        assert isinstance(port.final_layer, torch.nn.Conv2d)
    for train in (False, True):
        port.train(train)
        R, t = port(torch.from_numpy(x0), torch.from_numpy(x1))
        Rj, tj_ = _flax_apply(flax, v, jnp.asarray(x0), jnp.asarray(x1), train=train)
        _close(R, Rj, OUT_ATOL)
        _close(t, tj_, OUT_ATOL)


@pytest.mark.parametrize("h,w,n", [(4, 5, 2), (8, 10, 6)])
def test_posenet_matches_flax(h, w, n):
    """``PoseNet`` at the 32x40 tracker's level 3 (4x5: 1x2 = 2 pixels after
    its two stride-2 convs) and at 8x10 (6 pixels), so that its confidence
    softmax runs over more than one pixel."""
    rng = np.random.RandomState(3)
    x0, x1 = (rng.randn(B, 128, h, w).astype(np.float32) for _ in range(2))
    flax = jn.PoseNet(scale_motion=0.5)
    v = jax.jit(lambda k, *a: flax.init(k, *a))(jax.random.PRNGKey(5), jnp.asarray(x0),
                                                jnp.asarray(x1))
    port = _load(tn.PoseNet(128, scale_motion=0.5), v, "pose_predictor.", "pose_predictor")
    with torch.no_grad():
        port.eval()
        assert port.feat_net(torch.from_numpy(x0))[0].shape == (B, 256, n)
    for train in (False, True):
        port.train(train)
        R, t = port(torch.from_numpy(x0), torch.from_numpy(x1))
        Rj, tj_ = _flax_apply(flax, v, jnp.asarray(x0), jnp.asarray(x1), train=train)
        _close(R, Rj, OUT_ATOL)
        _close(t, tj_, OUT_ATOL)


def _jax_tracker(preset, overrides):
    return JaxTracker(cfg=jp.apply_overrides(jp.get_preset(preset), list(overrides)))


def _pair(preset, overrides, seed=3):
    """(the port tracker with seeded weights, the JAX tracker, its
    variables): the port's weights carried over by the JAX package's
    ``convert_state_dict``, except for ``PoseNet``'s (a flax init carried
    back by ``from_flax``)."""
    port = LeastSquareTracking(apply_overrides(get_preset(preset), overrides))
    net = _jax_tracker(preset, overrides)
    if port.cfg.init_pose_type == "dense_net":
        v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(
            jax.random.PRNGKey(seed), *map(jnp.asarray, _inputs()))
        port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
        return port, net, v
    port.reset_parameters(seed)
    conv = convert_state_dict(port.state_dict())
    assert not conv["unmapped"], sorted(conv["unmapped"])
    v = {c: conv[c] for c in ("params", "batch_stats")}
    # and back: from_flax maps every leaf onto the port's keys
    back = from_flax(v)
    assert set(back) == set(port.state_dict())
    for k, t in back.items():
        torch.testing.assert_close(t, port.state_dict()[k].to(t.dtype), rtol=0, atol=0)
    return port, net, v


def test_no_weight_sharing_has_a_module_a_level():
    port, _, v = _pair("DeepIC", ("no_weight_sharing=1",))
    assert {f"mests_{i}" for i in range(4)} <= set(v["params"])
    assert {f"damping_nets_{i}" for i in range(4)} <= set(v["params"])
    keys = port.state_dict().keys()
    for name in ("mEst_func", "solver_func"):
        assert not any(k.startswith(f"{name}.") for k in keys)
        for level in range(4):
            assert port._instance(name, level) is getattr(port, f"{name}{level}")
    assert port._instance("mEst_func", 2) is not port._instance("mEst_func", 1)
    shared = LeastSquareTracking(get_preset("DeepIC"))
    assert all(shared._instance("mEst_func", level) is shared.mEst_func for level in range(4))


PER_LEVEL = ("no_weight_sharing=1", "scaler=MultiScale2w", "mest_type=MultiScale2w",
             "solver_type=Direct-ResVol")


def test_per_level_weights_map_both_ways(tmp_path):
    """A ``no_weight_sharing`` ``DeepIC`` flax tree maps onto the port's
    per-level modules with nothing left over; a reference-style
    ``state_dict`` with ``mEst_func``/``mEst_func{l}``, ``scaler_func{l}``
    and ``solver_func{l}`` names (level 0 bare, as the JAX package's
    converter reads it) and the ``tr_update{l}`` aliases maps with nothing
    unmapped, through ``import_checkpoint`` and through the JAX
    converter."""
    from deep_prob_feature_track_torch.apps import import_checkpoint as pic
    from deep_prob_feature_track_torch.training import checkpoints

    net = _jax_tracker("DeepIC", ("no_weight_sharing=1",))
    sds = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in _inputs()]
    shapes = jax.eval_shape(lambda k, *a: net.init(k, *a, train=False),
                            jax.random.PRNGKey(0), *sds)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), dict(shapes))
    port = LeastSquareTracking(apply_overrides(get_preset("DeepIC"), ["no_weight_sharing=1"]))
    port.load_state_dict(from_flax(tree), strict=True)
    torch.testing.assert_close(port.mEst_func3.net[0][0].weight.permute(2, 3, 1, 0),
                               torch.from_numpy(tree["params"]["mests_3"]["ConvBlock_0"]
                                                ["Conv_0"]["kernel"]))
    source = LeastSquareTracking(apply_overrides(get_preset("feature_icp"), PER_LEVEL))
    target = source.reset_parameters(5).state_dict()
    ref = {}
    for k, v in target.items():
        for name in ("mEst_func", "scaler_func", "solver_func"):
            k = k.replace(f"{name}0.", f"{name}.")
        ref[k] = v
    ref.update({f"tr_update{i}.mEstimator.{k[len('mEst_func1.'):]}": v for i in (1, 2, 3)
                for k, v in target.items() if k.startswith(f"mEst_func{i}.")})
    assert any(k.startswith("scaler_func2.net.4.") for k in ref)
    fresh = LeastSquareTracking(apply_overrides(get_preset("feature_icp"), PER_LEVEL))
    mapped, unmapped = pic.map_state_dict(ref, fresh.state_dict())
    assert not unmapped and set(mapped) == set(target)
    assert all(torch.equal(mapped[k], target[k]) for k in target)
    conv = convert_state_dict(ref)
    assert not conv["unmapped"] and {"mests_3", "scalers_3", "damping_nets_3"} <= set(
        conv["params"])
    back = from_flax({c: conv[c] for c in ("params", "batch_stats")})
    assert set(back) == set(target)
    # the CLI builds the preset with a module a level from the file's level-1 names
    assert pic.has_level_modules(ref)
    assert not pic.has_level_modules(LeastSquareTracking(get_preset("DeepIC")).state_dict())
    levels = port.reset_parameters(6).state_dict()
    src = str(tmp_path / "levels.pth.tar")
    torch.save({"state_dict": {k.replace("mEst_func0.", "mEst_func.")
                               .replace("solver_func0.", "solver_func."): v
                               for k, v in levels.items()}}, src)
    assert pic.main(["--torch_checkpoint", src, "--preset", "DeepIC", "--strict",
                     "--output", str(tmp_path / "levels.pt")]) == 0
    got = checkpoints.restore_variables(str(tmp_path / "levels.pt"))
    assert set(got) == set(levels) and all(torch.equal(got[k], levels[k]) for k in levels)


def _counting(monkeypatch, calls):
    for mod, name in ((tw, "gather_twohot"), (tw, "gather_twohot_grads"),
                      (tw, "splat_twohot"), (tj, "fused_jtj_jtr"), (kj, "fused_jtj_jtr")):
        def call(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)


def test_learned_scale_gathers_as_pinned(monkeypatch):
    """``feature_icp``'s forward runs K1 24 and K6 12 times with the
    constant scale, and with a learned one K1 3 times more (the prior
    weights' upsamples at levels 2-0): the scale reads the first
    iteration's residuals, which that iteration solves with.  One step
    with the learned scale: K2 27 (24 warps and 3 upsamples), K3 15 (12
    feature warps and 3 upsamples; the ICP operand needs no cotangent), K6
    12."""
    ins = list(map(torch.from_numpy, _inputs()))
    for overrides, expected in (((), {"gather_twohot": 24, "fused_jtj_jtr": 12}),
                                (SCALE, {"gather_twohot": 27, "fused_jtj_jtr": 12})):
        port = LeastSquareTracking(apply_overrides(get_preset("feature_icp"), overrides))
        port.reset_parameters(3)
        calls = {}
        with monkeypatch.context() as m:
            _counting(m, calls)
            with torch.inference_mode():
                port(*ins)
        assert calls == expected, overrides
    calls = {}
    port.train()
    with monkeypatch.context() as m:
        _counting(m, calls)
        pyr_R, pyr_t = port(*ins)
        (pyr_t.square().sum() + pyr_R.sum()).backward()
    assert calls == {"gather_twohot_grads": 27, "splat_twohot": 15, "fused_jtj_jtr": 12}
    assert port.scaler_func.net[0][0].weight.grad.abs().max() > 0


# every value of every field the JAX package's TrackerConfig accepts
VALUES = {
    "encoder_name": ("RGB", "ConvRGBD", "ConvRGBD2", "ICP"),
    "direction": ("inverse", "forward"),
    "mest_type": ("None", "Huber", "MultiScale2w"),
    "solver_type": ("Direct-Nodamping", "Direct-ResVol"),
    "feature_extract": ("1by1", "conv", "skip", "average", "prob_fuse"),
    "scaler": ("None", "oneResidual", "twoResidual", "MultiScale2w", "expMultiScale"),
    "init_pose_type": ("identity", "sfm_net", "dense_net"),
    "multi_hypo": ("None", "average", "prob_fuse"),
    "res_input": (False, True),
    "uncer_prop": (False, True),
    "no_weight_sharing": (False, True),
    "combine_icp": (False, True),
    "train_init_pose": (False, True),
    "remove_tru_sigma": (False, True),
}


@pytest.mark.parametrize("field", sorted(VALUES))
def test_every_tracker_config_value_builds(field):
    for value in VALUES[field]:
        cfg = dataclasses.replace(TrackerConfig(combine_icp=True), **{field: value})
        LeastSquareTracking(cfg)
    with pytest.raises(ValueError):
        LeastSquareTracking(TrackerConfig(encoder_name="ConvRGBD3"))
    with pytest.raises(ValueError):
        LeastSquareTracking(TrackerConfig(init_pose_type="flow_net"))
