"""PyTorch port vs the JAX package: object masks in the building blocks of
the level solves: bool pyramids, ``merge_object_masks``, the inverse and
the warped residuals, and the ICP residual, on the scene and with the
tolerances of ``tests/test_torch_port_objmask.py`` (bool maps bit for bit,
every other map atol 1e-5 with rtol 1e-5).  Each mask is tested alone and
with the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.ops.image import image_pyramid
from deep_prob_feature_track_torch.solvers import icp as ticp
from deep_prob_feature_track_torch.solvers import residuals as tres
from deep_prob_feature_track_tpu.ops import image as jimage
from deep_prob_feature_track_tpu.solvers import icp as jicp
from deep_prob_feature_track_tpu.solvers import residuals as jres
from tests.test_torch_port_objmask import (  # noqa: F401  (scene: the module's fixture)
    B, H, MASKS, W, _close, _j, _masks, _t, _vertices, scene)


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
