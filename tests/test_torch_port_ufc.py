"""PyTorch port vs the JAX package: the forward-compositional U_FC track
(the paper model with ``direction=forward``), its building blocks, its
eval forward and its serving, on the CPU.

B=2 at 32x40 on the inputs of ``tests/test_golden.py``; weights are the
flax ``PRNGKey(7)`` init of the U_FC tracker with the learned
``MultiScale2w`` estimator, carried over by ``from_flax`` (the plain U_FC
tracker takes the same variables but the estimator's).  The level solves
start from a non-identity pose: at an exactly-identity pose the
forward-warped coordinates land bitwise on the in-view bounds
(``tests/test_training.py::_ufc_learned_mest_cfg``).

Tolerances: the forward warp's coordinates and
depth rtol 1e-6, its masks equal and its Jacobians within 1e-6 of their
largest entry; the level solves atol 1e-5 with rtol 1e-5 on R, t and the
weights, 1e-5 of the largest entry on JtWJ; the whole forward ``ATOL`` on
R and t.  At 96x448 level 0's C=28 operand takes K4's plain version, the
other levels K1's, against the JAX package's XLA gathers, within ``ATOL``.
``apply_overrides`` and ``_coerce`` are held in
``tests/test_torch_port_ufc_config.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps.serve import build_service, build_tracker
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models import presets as tp
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.models import nets as jnets
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.solvers import trust_region as jtr

torch.set_num_threads(2)

B, H, W = 2, 32, 40
KEYS = ("color0", "color1", "depth0", "depth1", "calib")
UFC = ["direction=forward"]
UFC_MEST = ["direction=forward", "mest_type=MultiScale2w"]
# max |dR|, |dt| of the port's eval forward against the JAX forward, measured
# on the golden inputs on the CPU: 2.4e-7 / 6.5e-7 (U_FC), 5.7e-7 / 1.6e-6
# (with the learned estimator).  Bounded at 1e-5, the acceptance bound.
ATOL = 1e-5
KERNELS = ("gather_twohot", "gather_twohot_grads", "splat_twohot", "gather_tiles",
           "gather_tiles_grads")


def _golden_inputs():
    rng = np.random.RandomState(42)
    return (
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.rand(B, 3, H, W).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32),
    )


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


def _counting(monkeypatch, calls):
    """Count each kernel wrapper's calls, as the warp makes them."""
    for name in KERNELS:
        def call(*a, _fn=getattr(tw, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(tw, name, call)


@pytest.fixture(scope="module")
def variables():
    """The PRNGKey(7) flax variables of the U_FC tracker with the learned
    estimator, as numpy."""
    net = JaxTracker(cfg=jp.apply_overrides(jp.get_preset("feature"), UFC_MEST))
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(
        jax.random.PRNGKey(7), *_j(*_golden_inputs()))
    return jax.tree.map(np.asarray, dict(v))


def _without_mest(v):
    return {c: {k: t for k, t in v[c].items() if k != "mests_0"} for c in v}


def _models(variables, pairs):
    """(JAX tracker, its variables, the port tracker loaded with them)."""
    v = variables if "mest_type=MultiScale2w" in pairs else _without_mest(variables)
    net = JaxTracker(cfg=jp.apply_overrides(jp.get_preset("feature"), pairs))
    port = LeastSquareTracking(tp.apply_overrides(tp.get_preset("feature"), pairs))
    port.load_state_dict(from_flax(v), strict=True)
    return net, v, port


# ------------------------------------------------------- the level solve


@pytest.fixture(scope="module")
def scene():
    """8-channel features, 1-channel sigmas and depth maps of both frames,
    intrinsics, a non-identity pose, and prior weights at half the level's
    size; a few pixels of frame 0 with zero depth."""
    rng = np.random.RandomState(3)
    d0 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    d0[:, :, 5, 7:11] = 0.0
    R = np.array(jl.exp_so3(jnp.asarray([[0.02, -0.01, 0.015], [-0.01, 0.02, 0.005]],
                                        jnp.float32)))
    return {
        "x0": rng.rand(B, 8, H, W).astype(np.float32),
        "x1": rng.rand(B, 8, H, W).astype(np.float32),
        "d0": d0,
        "d1": rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32),
        "s0": rng.uniform(0.5, 1.5, (B, 1, H, W)).astype(np.float32),
        "s1": rng.uniform(0.5, 1.5, (B, 1, H, W)).astype(np.float32),
        "K": np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32),
        "R": R,
        # batch 1 has no motion along z: its zero-depth pixels land at z = 0
        "t": np.asarray([[0.01, -0.02, 0.015], [0.005, 0.01, 0.0]], np.float32),
        "w_prior": rng.uniform(0.2, 0.8, (B, 1, H // 2, W // 2)).astype(np.float32),
    }


def test_warp_forward_depth_matches_jax(scene):
    s = scene
    ref = jax.jit(jtr._warp_forward_depth)(jnp.asarray(s["d0"]), _j(s["R"], s["t"]),
                                           jnp.asarray(s["K"]))
    got = ttr._warp_forward_depth(*_t(s["d0"]), _t(s["R"], s["t"]), *_t(s["K"]))
    assert len(got) == 6
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for g, r in zip(got[4:], ref[4:]):
        assert g.shape == (B, H * W, 6)
        _close(g, r, rel=1e-6)
    # the zero-depth pixels: z = t_z, invalid where it is 0
    assert got[2][1, 0, 5, 7:11].eq(0).all() and not got[3][1, 0, 5, 7:11].any()
    assert got[3][0, 0, 5, 7:11].all()


@pytest.mark.parametrize("mest", ["None", "MultiScale2w"])
def test_tr_ufc_level_matches_jax(variables, scene, mest):
    """Three iterations of one level from a non-identity pose; the learned
    estimator with eval BatchNorm on prior weights of half the size."""
    s = scene
    args = [s[k] for k in ("x0", "x1", "d0", "d1", "K", "s0", "s1")]
    if mest == "None":
        port_mest = LeastSquareTracking(
            tp.apply_overrides(tp.get_preset("feature"), UFC))._mest_at(0)

        def jax_mest(r, f0, f1, w):
            return jnets.DeepRobustEstimator("None").apply({}, r, f0, f1, w)
    else:
        port_mest = _models(variables, UFC_MEST)[2]._mest_at(0)
        mvars = {c: variables[c]["mests_0"] for c in ("params", "batch_stats")}

        def jax_mest(r, f0, f1, w):
            return jnets.DeepRobustEstimator("MultiScale2w").apply(mvars, r, f0, f1, w)

    solver_j = jtr.DirectSolver(kind="nodamping", direction="forward")
    level = jax.jit(lambda p, wp, *a: jtr.tr_ufc_level(p, *a, jax_mest, solver_j, w_prior=wp,
                                                        max_iter=3))
    (Rj, tj), wj, Hj = level(_j(s["R"], s["t"]), jnp.asarray(s["w_prior"]), *_j(*args))
    with torch.no_grad():
        (R, t), w, JtWJ = ttr.tr_ufc_level(
            _t(s["R"], s["t"]), *_t(*args), port_mest, ttr.DirectSolver("nodamping", "forward"),
            w_prior=torch.from_numpy(s["w_prior"]), max_iter=3)
    _close(R, Rj)
    _close(t, tj)
    _close(w, wj)
    _close(JtWJ, Hj, rel=1e-5)
    assert not np.allclose(t.numpy(), s["t"], atol=1e-4)  # the solve moved
    if mest == "MultiScale2w":
        assert 0.0 < w.min() and w.max() < 1.0 and w.shape == (B, 1, H, W)


def test_tr_ufc_level_takes_only_the_direction_of_the_solver(scene):
    """A ``resvol`` solver's damping net is built but never applied by the
    U_FC level (the JAX ``_update``): the pose equals the ``nodamping``
    solve's bit for bit, and the net is never called."""
    s = scene
    args = _t(*[s[k] for k in ("x0", "x1", "d0", "d1", "K", "s0", "s1")])
    mest = LeastSquareTracking(tp.apply_overrides(tp.get_preset("feature"), UFC))._mest_at(0)

    def never(x):
        raise AssertionError("the damping net ran")

    with torch.no_grad():
        poses = [ttr.tr_ufc_level(_t(s["R"], s["t"]), *args, mest, solver, max_iter=2)[0]
                 for solver in (ttr.DirectSolver("nodamping", "forward"),
                                ttr.DirectSolver("resvol", "forward", 10, never))]
    for a, b in zip(*poses):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------ the whole forward


@pytest.mark.parametrize("pairs", [UFC, UFC_MEST], ids=["U_FC", "U_FC_MultiScale2w"])
def test_forward_matches_jax(variables, pairs):
    net, v, port = _models(variables, pairs)
    Rj, tj = jax.jit(lambda v, *a: net.apply(v, *a, train=False))(v, *_j(*_golden_inputs()))
    with torch.inference_mode():
        R, t = port(*_t(*_golden_inputs()))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=ATOL)
    assert port.cfg.track_type == "U_FC"
    assert not np.allclose(t.numpy(), 0.0, atol=1e-3)


@pytest.mark.parametrize("pairs,expected", [(UFC, 12), (UFC_MEST, 21)],
                         ids=["U_FC", "U_FC_MultiScale2w"])
def test_forward_gathers_as_pinned(variables, monkeypatch, pairs, expected):
    """The eval forward samples through K1's wrapper once an iteration, on
    the C=28 operand ``[depth, x, sigma, grad x (x, y), grad sigma (x,
    y)]`` (1+8+1+8+8+1+1), and through no other kernel's; the learned
    estimator upsamples its prior weights (C=1) once an iteration at
    levels 2, 1 and 0 (not at the zero residual: in eval those weights are
    never read)."""
    calls, channels = {}, []
    _counting(monkeypatch, calls)
    sample = tw.gather_twohot
    monkeypatch.setattr(tw, "gather_twohot",
                        lambda F, *a: channels.append(F.shape[-1]) or sample(F, *a))
    port = _models(variables, pairs)[2]
    with torch.inference_mode():
        port(*_t(*_golden_inputs()))
    assert calls == {"gather_twohot": expected}
    assert channels.count(28) == 12 and channels.count(1) == expected - 12


def test_build_and_serve_on_cpu():
    """Served U_FC requests get the direct forward's pose of a batch padded
    with copies of them; ``build_tracker`` applies the overrides."""
    net = build_tracker("feature", device="cpu", seed=4, overrides=UFC)
    assert net.cfg.track_type == "U_FC" and not net.training
    svc = build_service("feature", "", max_batch=2, H=H, W=W, device="cpu", seed=4,
                        batch_timeout_ms=1.0, overrides=UFC)
    try:
        ins = _golden_inputs()
        outs = [svc.submit({k: a[i] for k, a in zip(KEYS, ins)}, timeout=120) for i in (0, 1)]
    finally:
        svc.stop()
    for i, out in enumerate(outs):
        with torch.inference_mode():
            R, t = net(*[torch.from_numpy(np.stack([a[i], a[i]])) for a in ins])
        np.testing.assert_allclose(out["R"], R[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(out["t"], t[0].numpy(), atol=1e-5)


# --------------------------------------------------- the route at 96x448

B_SLICE, H_SLICE, W_SLICE = 2, 96, 448
# the port's forward against the JAX one at 96x448 on the smooth scene:
# measured 2.8e-9 / 4.0e-9 on R / t on the CPU; held to ATOL


def test_forward_at_96x448_routes_level_0_through_k4_and_matches_jax(variables, monkeypatch):
    """Level 0's C=28 operand at 96x448 takes K4 (the JAX tile gate: W*C
    = 12544 > 4000, Cp = 32 fits the tile budget), levels 1-3 K1; the
    training forward takes K2 everywhere (the grads tile gate refuses Cp
    > 16).  The forward matches the JAX one within ``ATOL``."""
    net, v, port = _models(variables, UFC)
    batch = {k: a.numpy() for k, a in tt.synthetic_batch(B_SLICE, H_SLICE, W_SLICE,
                                                         seed=3, device="cpu").items()}
    calls = {}
    _counting(monkeypatch, calls)
    with torch.inference_mode():
        R, t = port(*[torch.from_numpy(batch[k]) for k in KEYS])
    assert calls == {"gather_tiles": 3, "gather_twohot": 9}
    Rj, tj = jax.jit(lambda v, *a: net.apply(v, *a, train=False))(
        v, *[jnp.asarray(batch[k]) for k in KEYS])
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=ATOL)
    calls.clear()
    port.train()(*[torch.from_numpy(batch[k]) for k in KEYS])
    assert calls == {"gather_twohot_grads": 12}
