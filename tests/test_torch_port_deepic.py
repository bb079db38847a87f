"""PyTorch port vs the JAX package: the ``DeepIC`` preset (the IC track
with the learned ``MultiScale2w`` M-estimator and the ``Direct-ResVol``
damping solver over the ``average`` encoder), its modules and its level
solve, evaluated and served on the CPU.

B=2 at 32x40.  Weights are the flax ``PRNGKey(7)`` init carried over by
``from_flax``; inputs are those of ``tests/test_golden.py``.  The level
solves start from a non-identity pose.  Tolerances: atol 1e-5 of the
largest entry on the modules' outputs, 1e-6 on the align-corners resize,
equality on the damping samples, atol 1e-5 with rtol 1e-5 on maps and poses,
1e-5 of the largest entry on the 6x6 systems (their entries reach 1e6 here),
atol 1e-4 on R and t of the whole forward (the acceptance bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps.serve import build_service, build_tracker
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.layers import FcRelu
from deep_prob_feature_track_torch.models.nets import DampingRegressor, DeepRobustEstimator
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.image import bilinear_resize_align
from deep_prob_feature_track_torch.solvers import jacobians as tjac
from deep_prob_feature_track_torch.solvers import residuals as tres
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.models import encoder as jenc
from deep_prob_feature_track_tpu.models import layers as jlayers
from deep_prob_feature_track_tpu.models import nets as jnets
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.ops import image as jimage
from deep_prob_feature_track_tpu.solvers import jacobians as jjac
from deep_prob_feature_track_tpu.solvers import residuals as jres
from deep_prob_feature_track_tpu.solvers import trust_region as jtr

torch.set_num_threads(2)

B, H, W = 2, 32, 40
S = 10  # the preset's damping samples
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
def models():
    """(JAX tracker, its PRNGKey(7) variables as numpy, the port tracker
    loaded with them through ``from_flax(strict=True)``)."""
    net = JaxTracker(cfg=jp.get_preset("DeepIC"))
    ins = [jnp.asarray(a) for a in _golden_inputs()]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    v = jax.tree.map(np.asarray, dict(v))
    port = LeastSquareTracking(get_preset("DeepIC"))
    port.load_state_dict(from_flax(v), strict=True)
    return net, v, port


@pytest.fixture(scope="module")
def scene():
    """The golden inputs' grayscale images (C=1 features), inverse depths
    and intrinsics, their pixel grids, a non-identity pose and prior
    weights at half the level's size."""
    img0, img1, d0, d1, K = _golden_inputs()
    gray = [(i[:, 0:1] * 0.299 + i[:, 1:2] * 0.587 + i[:, 2:3] * 0.114).astype(np.float32)
            for i in (img0, img1)]
    R = np.array(jl.exp_so3(jnp.asarray([[0.02, -0.01, 0.015], [-0.01, 0.02, 0.005]],
                                        jnp.float32)))
    t = np.asarray([[0.01, -0.02, 0.015], [0.005, 0.01, -0.01]], np.float32)
    px, py = (np.asarray(a) for a in jw.generate_xy_grid(B, H, W, jnp.asarray(K)))
    w_prior = np.random.RandomState(3).uniform(0.2, 0.8, (B, 1, H // 2, W // 2))
    return {"x0": gray[0], "x1": gray[1], "invD0": (1.0 / d0).astype(np.float32),
            "invD1": (1.0 / d1).astype(np.float32), "K": K, "px": px, "py": py,
            "R": R, "t": t, "w_prior": w_prior.astype(np.float32)}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, ref, rel=None):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if rel is not None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _mest_vars(v):
    return {"params": v["params"]["mests_0"], "batch_stats": v["batch_stats"]["mests_0"]}


def _damping_fn(v):
    """The JAX damping MLP as a pure function of its input."""
    params = {"params": v["params"]["damping_nets_0"]}
    return lambda x: jnets.DampingRegressor().apply(params, x)


# ------------------------------------------------------------ modules


def test_fc_relu_matches_flax(models):
    _, v, port = models
    x = np.random.RandomState(0).randn(8, 6 * S + 36).astype(np.float32)
    layer = port.solver_func.net[0]
    assert isinstance(layer, FcRelu)
    ref = jlayers.FcRelu(128).apply({"params": v["params"]["damping_nets_0"]["FcRelu_0"]},
                                    jnp.asarray(x))
    _close(layer(torch.from_numpy(x)), ref, rel=1e-5)


def test_damping_regressor_matches_flax(models):
    """Inputs where every axis's output is positive for some rows and zeroed
    by the final ReLU for others."""
    _, v, port = models
    x = np.random.RandomState(1).randn(64, 6 * S + 36).astype(np.float32)
    ref = np.asarray(_damping_fn(v)(jnp.asarray(x)))
    assert ((ref > 0).any(0) & (ref == 0).any(0)).all(), ref
    got = port.solver_func(torch.from_numpy(x))
    assert isinstance(port.solver_func, DampingRegressor)
    _close(got, ref, rel=1e-5)
    assert torch.equal(got == 0, torch.from_numpy(ref == 0))


@pytest.mark.parametrize("kind", ["MultiScale2w", "Huber", "None"])
def test_m_estimator_matches_flax(models, scene, kind):
    """The learned estimator with the preset's weights (eval BatchNorm) at a
    level whose prior weights are half its size; Huber with its gradient
    stopped at the residual."""
    _, v, port = models
    rng = np.random.RandomState(2)
    res = (0.05 * rng.randn(B, 1, H, W)).astype(np.float32)
    args = (res, scene["x0"], scene["x1"], scene["w_prior"])
    mod = jnets.DeepRobustEstimator(kind)
    ref = mod.apply(_mest_vars(v) if kind == "MultiScale2w" else {}, *_j(*args))
    mest = port.mEst_func if kind == "MultiScale2w" else DeepRobustEstimator(kind)
    res_t, *rest = _t(*args)
    res_t.requires_grad_(True)
    got = mest(res_t, *rest)
    _close(got, ref, rel=1e-5)
    if kind == "Huber":
        assert 0 < (got < 1).float().mean() < 1  # both branches taken
        assert not got.requires_grad
    if kind == "MultiScale2w":
        assert mest.net[0][0].in_channels == 4


def test_average_encoder_has_no_heads_and_matches_flax(models):
    _, v, port = models
    img0, img1, d0, d1, _ = _golden_inputs()
    m = np.concatenate([img0, 1.0 / d0, img1, 1.0 / d1], axis=1).astype(np.float32)
    enc = jenc.FeaturePyramid(feature_channel=1, feature_extract="average",
                              uncertainty_type="None")
    feats_j, sig_j, _ = enc.apply({"params": v["params"]["encoder"],
                                   "batch_stats": v["batch_stats"]["encoder"]},
                                  jnp.asarray(m), False)
    with torch.no_grad():
        feats, sigmas, _ = port.encoder(torch.from_numpy(m))
    assert sigmas == [None] * 4 and sig_j == [None] * 4
    assert not any(k.startswith(("encoder.f_conv", "encoder.sigma_conv"))
                   for k in port.state_dict())
    for f, fj in zip(feats, feats_j):
        assert f.shape[1] == 1
        _close(f, fj, rel=1e-5)


@pytest.mark.parametrize("size", [(15, 20, 30, 40), (8, 10, 32, 40), (4, 5, 7, 9)])
def test_bilinear_resize_align_matches_jax(size):
    h, w, Ho, Wo = size
    x = np.random.RandomState(h).rand(B, 1, h, w).astype(np.float32)
    ref = np.asarray(jimage.bilinear_resize_align(jnp.asarray(x), Ho, Wo))
    for plain in (False, True):
        got = bilinear_resize_align(torch.from_numpy(x), Ho, Wo, plain=plain)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    xt = torch.from_numpy(x)
    assert bilinear_resize_align(xt, h, w) is xt  # no resize, no gather


@pytest.mark.parametrize("samples", [10, 2, 7, 16])
def test_damping_samples_equal_jax(samples):
    """The jitted ``jnp.logspace`` of the JAX solve, bit for bit (the eager
    one differs in the last bit of some samples; ``torch.logspace`` by up
    to 4.4e-7 relative)."""
    ref = np.asarray(jax.jit(lambda: jnp.logspace(-5.0, 5.0, samples, dtype=jnp.float32))())
    got = ttr._lambdas(samples, torch.float32, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_seeded_init_draws_every_weight_from_the_seed():
    """The damping MLP's linears take flax ``Dense``'s init (lecun-normal
    kernel truncated at 2 std, zero bias) from the seed, whatever the
    global RNG's state."""
    torch.manual_seed(0)
    a = LeastSquareTracking(get_preset("DeepIC")).reset_parameters(5).state_dict()
    torch.manual_seed(1)
    b = LeastSquareTracking(get_preset("DeepIC")).reset_parameters(5).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for i, fan_in in enumerate((6 * S + 36, 128, 256)):
        w = a[f"solver_func.net.{i}.0.weight"]
        std = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
        assert w.abs().max() <= 2 * std and w.std() > 0.5 * std
        assert torch.equal(a[f"solver_func.net.{i}.0.bias"], torch.zeros(w.shape[0]))


# ------------------------------------------------------ the resvol solve


def _ic_system(s):
    """The JAX and port IC systems at the scene's pose, weighted by random
    per-pixel weights, with each side's folded sample functions."""
    w = np.random.RandomState(4).uniform(0.2, 1.0, (B, 1, H, W)).astype(np.float32)
    args = ("invD0", "invD1", "x0", "x1", "px", "py", "K")
    pose_j, pose_t = _j(s["R"], s["t"]), _t(s["R"], s["t"])
    pre_j = jjac.precompute_ic(*_j(s["invD0"], s["x0"], s["px"], s["py"], s["K"]))
    pre_t = tjac.precompute_ic(*_t(s["invD0"], s["x0"], s["px"], s["py"], s["K"]))
    res_j, _ = jres.compute_warped_residual(pose_j, *_j(*[s[k] for k in args]))
    res_t, _ = tres.compute_warped_residual(pose_t, *_t(*[s[k] for k in args]))
    JtWJ_j, JtR_j = jjac.jtj_jtr(pre_j.fac, res_j, weights=jnp.asarray(w))
    JtWJ_t, JtR_t = tjac.jtj_jtr(pre_t.fac, res_t, weights=torch.from_numpy(w))

    def residual_j(p):
        return jres.compute_warped_residual(p, *_j(*[s[k] for k in args]))[0]

    def jtr_j(r):
        return jjac.jtr_only(pre_j.fac, r, weights=jnp.asarray(w))

    fold = [t.repeat(S, *[1] * (t.ndim - 1))
            for t in _t(*[s[k] for k in ("invD0", "x0", "px", "py", "K")])]
    ops = tres.make_ic_operands(*_t(s["x1"], s["invD1"]), S)

    def residual_t(p):
        return tres.warped_residual(p, *fold, ops)[0]

    def jtr_t(r):
        return tjac.jtr_only(pre_t.fac, r, weights=torch.from_numpy(w))

    return ((JtWJ_j, JtR_j, pose_j, residual_j, jtr_j),
            (JtWJ_t, JtR_t, pose_t, residual_t, jtr_t))


@pytest.mark.parametrize("direction", ["inverse", "forward"])
def test_resvol_hessian_and_direct_solve_match_jax(models, scene, direction):
    """The folded samples' Hessian and the update of ``direct_solve("resvol")``:
    the samples solve inverse-compositionally, the final update follows
    ``direction``."""
    _, v, port = models
    ref, got = _ic_system(scene)
    solver_j = jtr.DirectSolver(kind="resvol", direction=direction, samples=S,
                                damping_mlp=_damping_fn(v), damping_pure=True)
    solver_t = ttr.DirectSolver("resvol", direction, S, port.solver_func)
    H_j = jax.jit(lambda *a: jtr._resvol_hessian(solver_j, *a[:3], *ref[3:]))(*ref[:3])
    with torch.no_grad():
        H_t = ttr._resvol_hessian(solver_t, *got)
        R, t = ttr.direct_solve(solver_t, *got)
    _close(H_t, H_j, rel=1e-5)
    Rj, tj = jax.jit(lambda *a: jtr.direct_solve(solver_j, *a[:3], *ref[3:]))(*ref[:3])
    _close(R, Rj)
    _close(t, tj)
    damp = torch.diagonal(H_t - got[0], dim1=1, dim2=2)
    assert (damp > 0).any()  # the regressed damping is on
    with pytest.raises(ValueError):
        ttr.direct_solve(ttr.DirectSolver("resvol"), *got[:3])


def test_jtr_only_broadcasts_over_folded_samples(scene):
    """A residual of S*B planes, sample-major, reduces as S separate
    batches with the same factors and weights (within 1e-5 of the largest
    entry: the folded product sums in other blocks)."""
    s = scene
    pre = tjac.precompute_ic(*_t(s["invD0"], s["x0"], s["px"], s["py"], s["K"]))
    w = torch.rand(B, 1, H, W, generator=torch.Generator().manual_seed(0))
    res = torch.randn(3 * B, 1, H, W, generator=torch.Generator().manual_seed(1))
    folded = tjac.jtr_only(pre.fac, res, weights=w)
    for i in range(3):
        _close(folded[i * B:(i + 1) * B],
               tjac.jtr_only(pre.fac, res[i * B:(i + 1) * B], weights=w), rel=1e-5)


def test_tr_ic_level_with_learned_modules_matches_jax(models, scene):
    """One IC level with the learned M-estimator (eval BatchNorm) and the
    residual-volume damping, from a non-identity pose."""
    _, v, port = models
    s = scene
    args = [s[k] for k in ("x0", "x1", "invD0", "invD1", "K")]
    mest_j = jnets.DeepRobustEstimator("MultiScale2w")
    solver_j = jtr.DirectSolver(kind="resvol", samples=S, damping_mlp=_damping_fn(v),
                                damping_pure=True)
    level = jax.jit(lambda p, wp, *a: jtr.tr_ic_level(
        p, *a, lambda r, f0, f1, w: mest_j.apply(_mest_vars(v), r, f0, f1, w), solver_j,
        w_prior=wp, max_iter=3))
    (Rj, tj), wj, Hj = level(_j(s["R"], s["t"]), jnp.asarray(s["w_prior"]), *_j(*args))
    with torch.no_grad():
        (R, t), w, JtWJ = ttr.tr_ic_level(
            _t(s["R"], s["t"]), *_t(*args), port._mest_at(0),
            ttr.DirectSolver("resvol", "inverse", S, port.solver_func),
            w_prior=torch.from_numpy(s["w_prior"]), max_iter=3)
    _close(R, Rj)
    _close(t, tj)
    _close(w, wj)
    _close(JtWJ, Hj, rel=1e-5)
    assert not np.allclose(R.numpy(), s["R"], atol=1e-4)


# ------------------------------------------------------ the whole preset


@pytest.fixture(scope="module")
def port_pose(models):
    with torch.inference_mode():
        R, t = models[2](*map(torch.from_numpy, _golden_inputs()))
    return R.numpy(), t.numpy()


def test_forward_matches_jax(models, port_pose):
    net, v, _ = models
    Rj, tj = jax.jit(lambda v, *a: net.apply(v, *a, train=False))(
        v, *map(jnp.asarray, _golden_inputs()))
    np.testing.assert_allclose(port_pose[0], np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(port_pose[1], np.asarray(tj), atol=1e-4)
    assert not np.allclose(port_pose[1], 0.0, atol=1e-4)  # the solve moved off the identity


def test_forward_gathers_as_pinned(models, monkeypatch):
    """The eval forward samples through K1's wrapper 51 times and through
    no other kernel's: 12 a level (the first residual, the folded damping
    samples of 3 iterations and 2 new residuals, each warping x1 and invD1)
    and the prior weights' upsample at levels 2, 1 and 0."""
    calls = {}

    def counting(name):
        fn = getattr(tw, name)

        def call(*a):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a)
        return call

    for name in ("gather_twohot", "gather_twohot_grads", "splat_twohot", "gather_tiles",
                 "gather_tiles_grads"):
        monkeypatch.setattr(tw, name, counting(name))
    with torch.inference_mode():
        models[2](*map(torch.from_numpy, _golden_inputs()))
    assert calls == {"gather_twohot": 51}


def test_from_flax_strict_and_back(models):
    """``from_flax`` maps every flax leaf (loaded with ``strict=True`` in
    the fixture); the JAX package's own bridge takes the port's
    ``state_dict`` back to the same tree with nothing unmapped."""
    _, v, port = models
    back = convert_state_dict(port.state_dict())
    assert back.pop("unmapped") == {}
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port.solver_func.net[0][0].weight.shape == (128, 6 * S + 36)
    assert len(jax.tree.leaves(v)) == 86  # 12 encoder blocks, 4 estimator blocks, 3 dense


def test_build_and_serve_on_cpu():
    """A served request gets the direct forward's pose of a batch padded
    with copies of it; the seeded init is the same for the same seed."""
    assert not build_tracker("DeepIC", device="cpu").training
    svc = build_service("DeepIC", "", max_batch=2, H=H, W=W, device="cpu", seed=4,
                        batch_timeout_ms=1.0)
    try:
        ins = _golden_inputs()
        out = svc.submit({k: a[0] for k, a in zip(KEYS, ins)}, timeout=120)
    finally:
        svc.stop()
    with torch.inference_mode():
        R, t = build_tracker("DeepIC", device="cpu", seed=4)(
            *[torch.from_numpy(np.stack([a[0], a[0]])) for a in ins])
    np.testing.assert_allclose(out["R"], R[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(out["t"], t[0].numpy(), atol=1e-5)
