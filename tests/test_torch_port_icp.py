"""PyTorch port vs the JAX package: the ICP and IC building blocks and the
level solves of the classical tracks and of U_IC with the fused ICP term.

B=2 at 32x40, with the depth maps and intrinsics of ``tests/test_golden.py``
(seed 42).  The level solves start from a non-identity pose: at identity the
ICP in-view test lands bitwise on frame edges, where the two programs may
round the other way.  Tolerance: atol 1e-5 with rtol 1e-5 on every map,
residual, Jacobian and pose; the 6x6 systems, whose entries reach 1e6 here,
within 1e-5 of their largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.nets import DeepRobustEstimator, ScaleNet
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.image import compute_normal
from deep_prob_feature_track_torch.solvers import icp as ticp
from deep_prob_feature_track_torch.solvers import jacobians as tjac
from deep_prob_feature_track_torch.solvers import residuals as tres
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.ops import image as jimage
from deep_prob_feature_track_tpu.solvers import icp as jicp
from deep_prob_feature_track_tpu.solvers import jacobians as jjac
from deep_prob_feature_track_tpu.solvers import residuals as jres
from deep_prob_feature_track_tpu.solvers import trust_region as jtr

torch.set_num_threads(2)

B, H, W = 2, 32, 40


@pytest.fixture(scope="module")
def scene():
    """The golden inputs' grayscale images, depths, inverse depths and
    intrinsics, their pixel grids, and a non-identity pose."""
    rng = np.random.RandomState(42)
    img0 = rng.rand(B, 3, H, W).astype(np.float32)
    img1 = rng.rand(B, 3, H, W).astype(np.float32)
    d0 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    d1 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    K = np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32)
    gray = [(i[:, 0:1] * 0.299 + i[:, 1:2] * 0.587 + i[:, 2:3] * 0.114).astype(np.float32)
            for i in (img0, img1)]
    R = np.array(jl.exp_so3(jnp.asarray([[0.02, -0.01, 0.015], [-0.01, 0.02, 0.005]],
                                        jnp.float32)))
    t = np.asarray([[0.01, -0.02, 0.015], [0.005, 0.01, -0.01]], np.float32)
    px, py = (np.asarray(a) for a in jw.generate_xy_grid(B, H, W, jnp.asarray(K)))
    return {"x0": gray[0], "x1": gray[1], "d0": d0, "d1": d1,
            "invD0": (1.0 / d0).astype(np.float32), "invD1": (1.0 / d1).astype(np.float32),
            "K": K, "px": px, "py": py, "R": R, "t": t}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, ref, rel=None):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.dtype == bool:
        np.testing.assert_array_equal(got, ref)
    elif rel is not None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _vertices(s):
    v0 = np.asarray(jw.compute_vertex(*_j(s["d0"], s["px"], s["py"])))
    v1 = np.asarray(jw.compute_vertex(*_j(s["d1"], s["px"], s["py"])))
    n1 = np.asarray(jimage.compute_normal(jnp.asarray(v1)))
    return v0, v1, n1


# ------------------------------------------------------------ geometry


def test_compute_vertex_and_batch_project(scene):
    s = scene
    v0 = tw.compute_vertex(*_t(s["d0"], s["px"], s["py"]))
    _close(v0, jw.compute_vertex(*_j(s["d0"], s["px"], s["py"])))
    _close(tw.batch_project(v0, torch.from_numpy(s["K"])),
           jw.batch_project(jnp.asarray(v0.numpy()), jnp.asarray(s["K"])))


@pytest.mark.parametrize("ranges", ["shared", "per_sample"])
def test_compute_normal_masks_the_batch_global_depth_range(scene, ranges):
    """With ``per_sample`` the two samples' depths lie in different ranges:
    a per-sample min/max would invalidate pixels in both, the batch-global
    one only the nearest pixel of sample 0 and the farthest of sample 1."""
    s = scene
    d = s["d1"].copy()
    if ranges == "per_sample":
        d[0] = 0.5 + (d[0] - 0.5) / 2.5   # [0.5, 1.5]
        d[1] = 2.0 + (d[1] - 0.5) / 2.5   # [2.0, 3.0]
    v = np.asarray(jw.compute_vertex(*_j(d, s["px"], s["py"])))
    got = compute_normal(*_t(v))
    _close(got, jimage.compute_normal(jnp.asarray(v)))
    zero = (got == 0).all(dim=1)
    assert zero.sum().item() == 2  # one pixel at the min, one at the max
    if ranges == "per_sample":
        assert zero[0].any() and zero[1].any()


def test_check_occ_and_warp_multi_at_six_channels(scene):
    s = scene
    rng = np.random.RandomState(1)
    u = rng.uniform(-2, W + 1, (B, 1, H, W)).astype(np.float32)
    v = rng.uniform(-2, H + 1, (B, 1, H, W)).astype(np.float32)
    v0, v1, n1 = _vertices(s)
    got = tw.warp_multi(_t(v1, n1), *_t(u, v))
    ref = jw.warp_multi(_j(v1, n1), *_j(u, v))
    assert [g.shape[1] for g in got] == [3, 3]
    for a, b in zip(got, ref):
        _close(a, b)
    _close(tw.warp_features(*_t(n1, u, v)), jw.warp_features(*_j(n1, u, v)))
    inv_z = (s["invD0"] * 1.02).astype(np.float32)
    # the JAX check_occ warps the inverse depth itself; the port's IC
    # residual hands its own warp of it to check_occ_prewarped
    inv_z_t, u_t, v_t = _t(inv_z, u, v)
    occ = tw.check_occ_prewarped(inv_z_t, tw.warp_features(*_t(s["invD1"], u, v)), u_t, v_t)
    _close(occ, jw.check_occ(*_j(inv_z, s["invD1"], u, v)))
    assert 0 < occ.sum().item() < occ.numel()


# ----------------------------------------------------- ICP residuals


@pytest.mark.parametrize("kind", ["inverse", "inverse_raw", "forward"])
def test_point_to_plane_residuals_and_normal_equations(scene, kind):
    s = scene
    v0, v1, n1 = _vertices(s)
    pose_t, pose_j = _t(s["R"], s["t"]), _j(s["R"], s["t"])
    if kind == "forward":
        got = ticp.icp_residuals_forward(*_t(v0, v1, n1), pose_t, torch.from_numpy(s["K"]))
        ref = jicp.icp_residuals_forward(*_j(v0, v1, n1), pose_j, jnp.asarray(s["K"]))
    else:
        raw = kind == "inverse_raw"
        model = ticp.ICPSigmaModel(baseline=1.0)
        got = ticp.icp_residuals_inverse(*_t(v0, v1, n1), pose_t, torch.from_numpy(s["K"]),
                                         sigma_model=model, normalize_residual=not raw)
        ref = jicp.icp_residuals_inverse(*_j(v0, v1, n1), pose_j, jnp.asarray(s["K"]),
                                         sigma_model=jicp.ICPSigmaModel(baseline=1.0),
                                         normalize_residual=not raw)
    for a, b in zip(got, ref):
        _close(a, b)
    occ = got[2]
    assert 0 < occ.sum().item() < occ.numel()
    assert (got[0][occ] == 1e-6).all()
    for a, b in zip(ticp.icp_jtj_jtr(got[1], got[0]), jicp.icp_jtj_jtr(ref[1], ref[0])):
        _close(a, b, rel=1e-5)


def test_compute_icp_sigma(scene):
    s = scene
    _, _, n1 = _vertices(s)
    model = ticp.ICPSigmaModel()
    got = ticp.compute_icp_sigma(*_t(s["d0"], n1, s["R"]), model)
    ref = jicp.compute_icp_sigma(*_j(s["d0"], n1, s["R"]), jicp.ICPSigmaModel())
    _close(got, ref)
    assert model == ticp.ICPSigmaModel(*jicp.ICPSigmaModel())


def test_point_to_point_residuals_and_normal_equations(scene):
    s = scene
    v0, v1, _ = _vertices(s)
    got = ticp.icp_residuals_point2point(*_t(v0, v1), _t(s["R"], s["t"]),
                                         torch.from_numpy(s["K"]), dist_thr=0.5)
    ref = jicp.icp_residuals_point2point(*_j(v0, v1), _j(s["R"], s["t"]),
                                         jnp.asarray(s["K"]), dist_thr=0.5)
    for a, b in zip(got, ref):
        _close(a, b)
    assert 0 < got[2].sum().item() < got[2].numel()
    for a, b in zip(ticp.icp_p2p_jtj_jtr(got[1], got[0]), jicp.icp_p2p_jtj_jtr(ref[1], ref[0])):
        _close(a, b, rel=1e-5)


# ------------------------------------------------------ the IC track


def test_warped_residual_and_weighted_ic_system(scene):
    s = scene
    args = ("invD0", "invD1", "x0", "x1", "px", "py", "K")
    res, occ = tres.compute_warped_residual(_t(s["R"], s["t"]), *_t(*[s[k] for k in args]))
    res_j, occ_j = jres.compute_warped_residual(_j(s["R"], s["t"]), *_j(*[s[k] for k in args]))
    _close(res, res_j)
    _close(occ, occ_j)
    assert (res[occ.expand_as(res)] == 1e-3).all()
    # a frame-0 object mask: the pixels outside it join the invalid ones
    mask = ~occ.numpy()
    mask[..., :10] = False
    res_m, occ_m = tres.compute_warped_residual(_t(s["R"], s["t"]), *_t(*[s[k] for k in args]),
                                                obj_mask0=torch.from_numpy(mask))
    res_mj, occ_mj = jres.compute_warped_residual(_j(s["R"], s["t"]), *_j(*[s[k] for k in args]),
                                                  obj_mask0=jnp.asarray(mask))
    _close(res_m, res_mj)
    _close(occ_m, occ_mj)
    assert occ_m.sum() > occ.sum()

    pre = tjac.precompute_ic(*_t(s["invD0"], s["x0"], s["px"], s["py"], s["K"]))
    pre_j = jjac.precompute_ic(*_j(s["invD0"], s["x0"], s["px"], s["py"], s["K"]))
    assert pre.fac.sign == pre_j.fac.sign == 1.0
    for a, b in zip(pre.fac[:4], pre_j.fac[:4]):
        _close(a, b)
    w = np.random.RandomState(2).uniform(0.2, 1.0, (B, 1, H, W)).astype(np.float32)
    for weights in (None, w):
        wt = None if weights is None else torch.from_numpy(weights)
        wj = None if weights is None else jnp.asarray(weights)
        for a, b in zip(tjac.jtj_jtr(pre.fac, res, weights=wt),
                        jjac.jtj_jtr(pre_j.fac, res_j, weights=wj)):
            _close(a, b, rel=1e-5)
        _close(tjac.jtr_only(pre.fac, res, weights=wt), jjac.jtr_only(pre_j.fac, res_j, weights=wj),
               rel=1e-5)


# ------------------------------------------------------- level solves


def _level_close(got, ref, moved_from=None):
    (R, t), (Rj, tj) = got[0], ref[0]
    _close(R, Rj)
    _close(t, tj)
    _close(got[-1], ref[-1], rel=1e-5)  # the last iteration's 6x6 system
    if moved_from is not None:
        assert not np.allclose(R.numpy(), moved_from, atol=1e-4)


def test_tr_ic_level_matches_jax(scene):
    s = scene
    args = [s[k] for k in ("x0", "x1", "invD0", "invD1", "K")]
    level = jax.jit(lambda p, *a: jtr.tr_ic_level(
        p, *a, lambda r, f0, f1, wp: jnp.ones_like(r), jtr.DirectSolver(kind="nodamping"),
        max_iter=3))
    ref = level(_j(s["R"], s["t"]), *_j(*args))
    got = ttr.tr_ic_level(_t(s["R"], s["t"]), *_t(*args), DeepRobustEstimator("None"),
                          ttr.DirectSolver("nodamping"), max_iter=3)
    _level_close(got, ref, moved_from=s["R"])
    _close(got[1], ref[1])
    # the IC track with an M-estimator per level is not ported
    with pytest.raises(NotImplementedError, match="no_weight_sharing"):
        LeastSquareTracking(dataclasses.replace(get_preset("RGB"), no_weight_sharing=True))


@pytest.mark.parametrize("direction", ["inverse", "forward"])
def test_tr_icp_level_matches_jax(scene, direction):
    s = scene
    args = [s[k] for k in ("d0", "d1", "K")]
    level = jax.jit(lambda p, *a: jtr.tr_icp_level(
        p, *a, max_iter=3, direction=direction,
        sigma_model=jicp.ICPSigmaModel(baseline=1.0)))
    ref = level(_j(s["R"], s["t"]), *_j(*args))
    got = ttr.tr_icp_level(_t(s["R"], s["t"]), *_t(*args), max_iter=3, direction=direction,
                           sigma_model=ticp.ICPSigmaModel(baseline=1.0))
    _level_close(got, ref, moved_from=s["R"])
    _close(got[1], ref[1])


def test_tr_icp_point_level_matches_jax(scene):
    s = scene
    args = [s[k] for k in ("d0", "d1", "K")]
    level = jax.jit(lambda p, *a: jtr.tr_icp_point_level(p, *a, max_iter=4, dist_thr=0.5))
    ref = level(_j(s["R"], s["t"]), *_j(*args))
    got = ttr.tr_icp_point_level(_t(s["R"], s["t"]), *_t(*args), max_iter=4, dist_thr=0.5)
    _level_close(got, ref, moved_from=s["R"])


@pytest.mark.parametrize("scale", ["per_pixel", "constant"])
def test_tr_uic_level_with_icp_matches_jax(scene, scale):
    """U_IC with the fused ICP term, feature-like operands (C=8, one sigma
    channel).  The port takes the ICP weights ``w_icp`` that the JAX
    function's ``scale_fn`` returns: ``per_pixel``, a map that varies over
    the pixels; ``constant``, the port's ``ScaleNet("None")`` at the shape
    of the ICP residual."""
    s = scene
    rng = np.random.RandomState(3)
    x0 = rng.randn(B, 8, H, W).astype(np.float32)
    x1 = (x0 + 0.1 * rng.randn(B, 8, H, W)).astype(np.float32)
    s0 = np.exp(rng.uniform(-1, 1, (B, 1, H, W))).astype(np.float32)
    s1 = np.exp(rng.uniform(-1, 1, (B, 1, H, W))).astype(np.float32)
    w_map = (0.01 + 0.005 * rng.rand(B, 1, H, W)).astype(np.float32)
    w_prior = np.full((B, 1, H // 2, W // 2), 0.001, np.float32)
    args = (x0, x1, s["invD0"], s["invD1"], s["K"], s0, s1)

    def jax_scale(icp_res, feat_res, wp):
        return jnp.asarray(w_map) if scale == "per_pixel" else jnp.ones_like(icp_res) * 0.01

    level = jax.jit(lambda p, *a: jtr.tr_uic_level(
        p, *a[:7], w_prior=a[7], depth0=a[8], depth1=a[9], scale_fn=jax_scale,
        max_iter=3, remove_tru_sigma=True, combine_icp=True))
    ref = level(_j(s["R"], s["t"]), *_j(*args, w_prior, s["d0"], s["d1"]))
    if scale == "per_pixel":
        w_icp = torch.from_numpy(w_map)
    else:
        w_icp = ScaleNet("None", scale=0.01)(torch.from_numpy(s["invD0"]), None,
                                             torch.from_numpy(w_prior))
    got = ttr.tr_uic_level(_t(s["R"], s["t"]), *_t(*args), depth0=torch.from_numpy(s["d0"]),
                           depth1=torch.from_numpy(s["d1"]), w_icp=w_icp, max_iter=3,
                           remove_tru_sigma=True)
    _level_close(got, ref, moved_from=s["R"])
    _close(got[1], ref[1])
    assert got[1].shape == (B, 1, H, W)
