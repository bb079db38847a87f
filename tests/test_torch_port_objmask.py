"""PyTorch port vs the JAX package: object masks in the building blocks and
the level solves (bool pyramids, the residuals, the ICP residual, every
``tr_*_level`` and ``tr_*_residual``).

B=2 at 32x40: the depth maps and intrinsics of ``tests/test_golden.py``
(seed 42), feature-like operands (C=8, one sigma channel) from seed 3, and
two object masks that cover part of the frame with their edges inside it:
an ellipse in frame 0 and a shifted, narrower one in frame 1, so that the
warped frame-1 mask is not the frame-0 one.  Each mask is tested alone and
with the other.  The level solves start from a non-identity pose.

The reference's asymmetries are held as its behaviour: the IC loop's
residuals take ``obj_mask1`` alone, ``tr_uic_residual``'s ICP term no
mask, and ``tr_ufc_residual``, ``tr_icp_level`` and ``tr_icp_residual``
take ``obj_mask1`` and ignore it.

Tolerances: bool maps (pyramids, invalid masks, the operand's mask
channel) bit for bit; every other map, residual, Jacobian and pose atol
1e-5 with rtol 1e-5; the 6x6 systems within 1e-5 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.nets import DeepRobustEstimator
from deep_prob_feature_track_torch.ops.image import image_pyramid
from deep_prob_feature_track_torch.solvers import icp as ticp
from deep_prob_feature_track_torch.solvers import residuals as tres
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.ops import image as jimage
from deep_prob_feature_track_tpu.solvers import icp as jicp
from deep_prob_feature_track_tpu.solvers import residuals as jres
from deep_prob_feature_track_tpu.solvers import trust_region as jtr

torch.set_num_threads(2)

B, H, W = 2, 32, 40
MASKS = ["obj_mask0", "obj_mask1", "both"]


def object_masks(b, h, w):
    """An ellipse in frame 0 and a shifted, narrower ellipse in frame 1,
    each covering part of the frame with its edge inside it: bool
    [b,1,h,w] each."""
    yy, xx = np.mgrid[0:h, 0:w]
    m0 = ((yy - 0.45 * h) / (0.3 * h)) ** 2 + ((xx - 0.5 * w) / (0.32 * w)) ** 2 < 1
    m1 = ((yy - 0.5 * h) / (0.3 * h)) ** 2 + ((xx - 0.55 * w) / (0.28 * w)) ** 2 < 1
    return (np.broadcast_to(m0, (b, 1, h, w)).copy(), np.broadcast_to(m1, (b, 1, h, w)).copy())


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(42)
    rng.rand(2 * B * 3 * H * W)  # the golden images, not used here
    d0 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    d1 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    K = np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32)
    rng = np.random.RandomState(3)
    x0 = rng.randn(B, 8, H, W).astype(np.float32)
    x1 = (x0 + 0.1 * rng.randn(B, 8, H, W)).astype(np.float32)
    s0 = np.exp(rng.uniform(-1, 1, (B, 1, H, W))).astype(np.float32)
    s1 = np.exp(rng.uniform(-1, 1, (B, 1, H, W))).astype(np.float32)
    R = np.array(jl.exp_so3(jnp.asarray([[0.02, -0.01, 0.015], [-0.01, 0.02, 0.005]],
                                        jnp.float32)))
    t = np.asarray([[0.01, -0.02, 0.015], [0.005, 0.01, -0.01]], np.float32)
    px, py = (np.asarray(a) for a in jw.generate_xy_grid(B, H, W, jnp.asarray(K)))
    m0, m1 = object_masks(B, H, W)
    return {"x0": x0, "x1": x1, "s0": s0, "s1": s1, "d0": d0, "d1": d1,
            "invD0": (1.0 / d0).astype(np.float32), "invD1": (1.0 / d1).astype(np.float32),
            "K": K, "px": px, "py": py, "R": R, "t": t, "m0": m0, "m1": m1}


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _masks(s, which):
    """``(obj_mask0, obj_mask1)`` numpy arrays of one case of ``MASKS``."""
    return (s["m0"] if which in ("obj_mask0", "both") else None,
            s["m1"] if which in ("obj_mask1", "both") else None)


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


def _level_close(got, ref, moved_from):
    (R, t), (Rj, tj) = got[0], ref[0]
    _close(R, Rj)
    _close(t, tj)
    _close(got[-1], ref[-1], rel=1e-5)  # the last iteration's 6x6 system
    assert not np.allclose(R.numpy(), moved_from, atol=1e-4)


def _vertices(s):
    v0 = np.asarray(jw.compute_vertex(*_j(s["d0"], s["px"], s["py"])))
    v1 = np.asarray(jw.compute_vertex(*_j(s["d1"], s["px"], s["py"])))
    return v0, v1, np.asarray(jimage.compute_normal(jnp.asarray(v1)))


# ------------------------------------------------------------ building blocks


def test_image_pyramid_of_a_bool_mask(scene):
    """Bit for bit, bool at every level; a window with one object pixel is
    object (a mask of one pixel survives to level 3)."""
    dot = np.zeros((B, 1, H, W), bool)
    dot[0, 0, 13, 21] = True
    for mask in (scene["m0"], scene["m1"], dot):
        got = image_pyramid(torch.from_numpy(mask))
        ref = jimage.image_pyramid(jnp.asarray(mask))
        assert len(got) == 4
        for g, r in zip(got, ref):
            assert g.dtype == torch.bool
            _close(g, r)
    assert got[3][0, 0, 1, 2] and got[3].sum() == 1


@pytest.mark.parametrize("which", MASKS)
def test_merge_object_masks(scene, which):
    s = scene
    rng = np.random.RandomState(5)
    occ = rng.rand(B, 1, H, W) < 0.1
    u = rng.uniform(-2, W + 1, (B, 1, H, W)).astype(np.float32)
    v = rng.uniform(-2, H + 1, (B, 1, H, W)).astype(np.float32)
    masks = _masks(s, which)
    got = tres.merge_object_masks(*_t(occ, u, v), *_t(*masks))
    ref = jres.merge_object_masks(*_j(occ, u, v), *_j(*masks))
    _close(got, ref)
    assert occ.sum() < got.sum().item() < occ.size


@pytest.mark.parametrize("which", MASKS)
def test_compute_inverse_residuals_with_masks(scene, which):
    """The residual, its invalid mask and the warp; the frame-1 mask is the
    operand's last channel (C=11)."""
    s = scene
    m0, m1 = _masks(s, which)
    pose_t, pose_j = _t(s["R"], s["t"]), _j(s["R"], s["t"])
    op = tres.build_inverse_warp_operand(*_t(s["invD1"], s["x1"], s["s1"], m1))
    got, u, v = tres.compute_inverse_residuals(
        pose_t, *_t(s["invD0"], s["x0"], s["s0"], s["px"], s["py"], s["K"]), op,
        obj_mask0=_t(m0)[0], remove_tru_sigma=True)
    ref, uj, vj = jres.compute_inverse_residuals(
        pose_j, *_j(s["invD0"], s["invD1"], s["x0"], s["x1"], s["s0"], s["s1"], s["px"],
                    s["py"], s["K"]), *_j(m0, m1), remove_tru_sigma=True)
    for a, b in zip((*got, u, v), (*ref, uj, vj)):
        _close(a, b)
    op_j = jres.build_inverse_warp_operand(*_j(s["invD1"], s["x1"], s["s1"], m1))
    assert op[1] == op_j[1] == ([1, 8, 1, 1] if m1 is not None else [1, 8, 1])
    _close(op[0], op_j[0])
    if m1 is not None:  # the mask channel is the mask, 0 or 1
        assert torch.equal(op[0][..., -1], torch.from_numpy(m1[:, 0]).float())
    assert 0 < got.invalid.sum().item() < got.invalid.numel()


@pytest.mark.parametrize("which", MASKS)
def test_compute_warped_residual_with_masks(scene, which):
    s = scene
    masks = _masks(s, which)
    args = [s[k] for k in ("invD0", "invD1", "x0", "x1", "px", "py", "K")]
    res, occ = tres.compute_warped_residual(_t(s["R"], s["t"]), *_t(*args), *_t(*masks))
    res_j, occ_j = jres.compute_warped_residual(_j(s["R"], s["t"]), *_j(*args), *_j(*masks))
    _close(res, res_j)
    _close(occ, occ_j)
    assert (res[occ.expand_as(res)] == 1e-3).all()


@pytest.mark.parametrize("which", MASKS)
def test_icp_residuals_inverse_with_masks(scene, which):
    """The frame-1 mask is the third map of the one fused gather (C=7)."""
    s = scene
    masks = _masks(s, which)
    v0, v1, n1 = _vertices(s)
    got = ticp.icp_residuals_inverse(*_t(v0, v1, n1), _t(s["R"], s["t"]),
                                     torch.from_numpy(s["K"]), *_t(*masks))
    ref = jicp.icp_residuals_inverse(*_j(v0, v1, n1), _j(s["R"], s["t"]), jnp.asarray(s["K"]),
                                     *_j(*masks))
    for a, b in zip(got, ref):
        _close(a, b)
    op = ticp.icp_operand(*_t(v1, n1, masks[1]))
    assert op[0].shape[-1] == (7 if masks[1] is not None else 6)


# --------------------------------------------------------------- level solves


@pytest.mark.parametrize("combine_icp", [False, True])
def test_tr_uic_level_with_masks(scene, combine_icp):
    """Both masks reach every feature residual and, with the fused ICP
    term, every ICP residual."""
    s = scene
    w_map = (0.01 + 0.005 * np.random.RandomState(4).rand(B, 1, H, W)).astype(np.float32)
    args = [s[k] for k in ("x0", "x1", "invD0", "invD1", "K", "s0", "s1")]
    level = jax.jit(lambda p, *a: jtr.tr_uic_level(
        p, *a[:7], depth0=a[7], depth1=a[8], obj_mask0=a[9], obj_mask1=a[10],
        scale_fn=lambda icp_res, feat_res, wp: jnp.asarray(w_map), max_iter=3,
        remove_tru_sigma=True, combine_icp=combine_icp))
    ref = level(_j(s["R"], s["t"]), *_j(*args, s["d0"], s["d1"], s["m0"], s["m1"]))
    got = ttr.tr_uic_level(_t(s["R"], s["t"]), *_t(*args), *_t(s["d0"], s["d1"]),
                           scale_fn=(lambda *_: torch.from_numpy(w_map)) if combine_icp
                           else None,
                           obj_mask0=_t(s["m0"])[0], obj_mask1=_t(s["m1"])[0], max_iter=3,
                           remove_tru_sigma=True)
    _level_close(got, ref, moved_from=s["R"])
    _close(got[1], ref[1])


@pytest.mark.parametrize("combine_icp", [False, True])
def test_tr_uic_residual_with_masks(scene, combine_icp):
    """The masks reach the feature residual; the ICP term gets none."""
    s = scene
    w_map = np.full((B, 1, H, W), 0.01, np.float32)
    args = [s[k] for k in ("x0", "x1", "invD0", "invD1", "K", "s0", "s1")]
    ref = jtr.tr_uic_residual(_j(s["R"], s["t"]), *_j(*args), depth0=jnp.asarray(s["d0"]),
                              depth1=jnp.asarray(s["d1"]), obj_mask0=jnp.asarray(s["m0"]),
                              obj_mask1=jnp.asarray(s["m1"]),
                              scale_fn=lambda icp_res, feat_res, wp: jnp.asarray(w_map),
                              remove_tru_sigma=True, combine_icp=combine_icp)
    got = ttr.tr_uic_residual(_t(s["R"], s["t"]), *_t(*args), *_t(s["d0"], s["d1"]),
                              scale_fn=(lambda *_: torch.from_numpy(w_map)) if combine_icp
                              else None,
                              obj_mask0=_t(s["m0"])[0], obj_mask1=_t(s["m1"])[0],
                              remove_tru_sigma=True)
    _close(got, ref)


@pytest.mark.parametrize("mest", ["None", "Huber"])
def test_tr_ic_level_with_masks(scene, mest):
    """The first residual takes both masks, the loop's residuals
    ``obj_mask1`` alone: ``obj_mask0`` reaches the weights and JtWJ, not
    the right-hand sides after the first.  ``Huber``: weights ``min(1,
    0.02 / |r|)``, which the masked residual's 1e-3 sets to 1."""
    s = scene
    args = [s[k] for k in ("x0", "x1", "invD0", "invD1", "K")]

    def weights(lib):
        if mest == "None":
            return lambda r, *_: lib.ones_like(r)
        if lib is torch:
            return lambda r, *_: torch.clamp(0.02 / r.abs(), max=1.0)
        return lambda r, *_: jnp.minimum(0.02 / jnp.abs(r), 1.0)

    level = jax.jit(lambda p, *a: jtr.tr_ic_level(
        p, *a[:5], weights(jnp), jtr.DirectSolver(kind="nodamping"), obj_mask0=a[5],
        obj_mask1=a[6], max_iter=3))
    ref = level(_j(s["R"], s["t"]), *_j(*args, s["m0"], s["m1"]))
    got = ttr.tr_ic_level(_t(s["R"], s["t"]), *_t(*args), weights(torch),
                          ttr.DirectSolver("nodamping"), obj_mask0=_t(s["m0"])[0],
                          obj_mask1=_t(s["m1"])[0], max_iter=3)
    _level_close(got, ref, moved_from=s["R"])
    if mest == "None":
        _close(got[1], ref[1])
    else:  # 0.02/|r| carries the residual's rounding: the warp's coordinates
        # round ~1e-6 pixel apart in the two programs, times the noise
        # features' gradients of order 1; outside the object both are 1
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=2e-4, atol=0)
        outside = ~np.broadcast_to(s["m0"], got[1].shape)
        assert (got[1].numpy()[outside] == 1.0).all()


def test_tr_ic_residual_with_masks(scene):
    s = scene
    args = [s[k] for k in ("x0", "x1", "invD0", "invD1", "K")]
    got = ttr.tr_ic_residual(_t(s["R"], s["t"]), *_t(*args), DeepRobustEstimator("None"),
                             obj_mask0=_t(s["m0"])[0], obj_mask1=_t(s["m1"])[0])
    ref = jtr.tr_ic_residual(_j(s["R"], s["t"]), *_j(*args), lambda r, f0, f1, wp:
                             jnp.ones_like(r), obj_mask0=jnp.asarray(s["m0"]),
                             obj_mask1=jnp.asarray(s["m1"]))
    _close(got, ref)


@pytest.mark.parametrize("which", MASKS)
def test_tr_ufc_level_with_masks(scene, which):
    """The frame-1 mask is the operand's eighth map (C=29 with the
    8-channel features); both masks fold into ``occ``."""
    s = scene
    masks = _masks(s, which)
    args = [s[k] for k in ("x0", "x1", "d0", "d1", "K", "s0", "s1")]
    solver_j = jtr.DirectSolver(kind="nodamping", direction="forward")
    level = jax.jit(lambda p, *a: jtr.tr_ufc_level(
        p, *a[:7], lambda r, f0, f1, wp: jnp.ones_like(r), solver_j, obj_mask0=a[7],
        obj_mask1=a[8], max_iter=3))
    ref = level(_j(s["R"], s["t"]), *_j(*args, *masks))
    got = ttr.tr_ufc_level(_t(s["R"], s["t"]), *_t(*args), DeepRobustEstimator("None"),
                           ttr.DirectSolver("nodamping", "forward"), obj_mask0=_t(masks[0])[0],
                           obj_mask1=_t(masks[1])[0], max_iter=3)
    _level_close(got, ref, moved_from=s["R"])


def test_tracks_that_ignore_the_masks(scene):
    """``tr_ufc_residual``, ``tr_icp_level`` and ``tr_icp_residual`` take
    ``obj_mask1`` and ignore it, in both packages: the masked result is the
    unmasked one."""
    s = scene
    pose_t, pose_j = _t(s["R"], s["t"]), _j(s["R"], s["t"])
    m1_t, m1_j = torch.from_numpy(s["m1"]), jnp.asarray(s["m1"])
    ufc = [s[k] for k in ("x0", "x1", "d0", "d1", "K", "s0", "s1")]
    got = ttr.tr_ufc_residual(pose_t, *_t(*ufc), obj_mask1=m1_t)
    ref = jtr.tr_ufc_residual(pose_j, *_j(*ufc), obj_mask1=m1_j)
    _close(got, ref)
    torch.testing.assert_close(got, ttr.tr_ufc_residual(pose_t, *_t(*ufc)), rtol=0, atol=0)
    icp = [s[k] for k in ("d0", "d1", "K")]
    model_j = jicp.ICPSigmaModel(baseline=1.0)
    got = ttr.tr_icp_residual(pose_t, *_t(*icp), obj_mask1=m1_t)
    _close(got, jtr.tr_icp_residual(pose_j, *_j(*icp), obj_mask1=m1_j, sigma_model=model_j))
    torch.testing.assert_close(got, ttr.tr_icp_residual(pose_t, *_t(*icp)), rtol=0, atol=0)
    level = jax.jit(lambda p, *a: jtr.tr_icp_level(p, *a[:3], obj_mask1=a[3], max_iter=3,
                                                   sigma_model=model_j))
    ref = level(pose_j, *_j(*icp), m1_j)
    got = ttr.tr_icp_level(pose_t, *_t(*icp), obj_mask1=m1_t, max_iter=3,
                           sigma_model=ticp.ICPSigmaModel(baseline=1.0))
    _level_close(got, ref, moved_from=s["R"])
    unmasked = ttr.tr_icp_level(pose_t, *_t(*icp), max_iter=3,
                                sigma_model=ticp.ICPSigmaModel(baseline=1.0))
    torch.testing.assert_close(got[0], unmasked[0], rtol=0, atol=0)
