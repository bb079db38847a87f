"""PyTorch port vs the JAX package: the residual at a fixed pose
(``compute_avg_loss``, ``compute_avg_res``, the ``tr_*_residual``
functions, ``LeastSquareTracking.compute_residual``) and the
convergence-basin study of ``apps/convergence_basin.py``.

The residual functions take the golden inputs of ``tests/test_golden.py``
(B=2, 32x40, seed 42) from a non-identity pose; ``compute_residual`` takes
the flax ``PRNGKey(7)`` weights of ``feature`` (shared by ``feature_icp``
and its U_FC variant) and of ``DeepIC`` through ``from_flax``; the basin
takes the second pair of a written 5-frame TUM-format sequence at 48x64.
Tolerances: the averages within 1e-5 relative (float32 sums of 1,280
pixels); the basin's costs within 1e-4 relative (each a float32 average
of up to 3,072 warped pixels, through the encoder).  The JAX basin runs
with 64-bit types off, as the JAX tool runs: with them on, its identity
padding is float64 and promotes every pose of the study to float64.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_prob_feature_track_torch.apps import convergence_basin as pcb
from deep_prob_feature_track_torch.data.loader import load_data
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.solvers import residuals as tres
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_tpu.apps import convergence_basin as jcb
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.solvers import residuals as jres
from deep_prob_feature_track_tpu.solvers import trust_region as jtr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_tum_sequence  # noqa: E402

torch.set_num_threads(2)
B, H, W = 2, 32, 40
KEYS = ("color0", "color1", "depth0", "depth1", "calib")


@pytest.fixture(scope="module")
def scene():
    """The golden inputs, a 1-channel feature pair with its sigma and a
    non-identity pose."""
    rng = np.random.RandomState(42)
    img0 = rng.rand(B, 3, H, W).astype(np.float32)
    img1 = rng.rand(B, 3, H, W).astype(np.float32)
    d0 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    d1 = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    K = np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32)
    R = np.array(jl.exp_so3(jnp.asarray([[0.02, -0.01, 0.015], [-0.01, 0.02, 0.005]],
                                        jnp.float32)))
    t = np.asarray([[0.01, -0.02, 0.015], [0.005, 0.01, -0.01]], np.float32)
    return {"img0": img0, "img1": img1, "x0": img0[:, :1], "x1": img1[:, :1],
            "s0": rng.uniform(0.5, 1.5, (B, 1, H, W)).astype(np.float32),
            "s1": rng.uniform(0.5, 1.5, (B, 1, H, W)).astype(np.float32),
            "d0": d0, "d1": d1, "invD0": 1.0 / d0, "invD1": 1.0 / d1, "K": K, "R": R, "t": t}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def test_compute_avg_loss_and_res_match_jax(rng):
    x = [rng.randn(3, 4, 6, 5).astype(np.float32) for _ in range(2)]
    invalid = rng.rand(3, 1, 6, 5) > 0.6
    invalid[1] = True  # an all-invalid frame reports 0, not NaN
    got = tres.compute_avg_loss(_t(*x), torch.from_numpy(invalid))
    ref = jres.compute_avg_loss(_j(*x), jnp.asarray(invalid))
    _close(got, ref)
    assert got[1].item() == 0.0
    _close(tres.compute_avg_res(*_t(x[0], invalid)), jres.compute_avg_res(*_j(x[0], invalid)))
    none = np.ones_like(invalid)
    assert tres.compute_avg_res(*_t(x[0], none)).item() == 0.0


@pytest.mark.parametrize("combine_icp", [False, True])
def test_tr_uic_residual_matches_jax(scene, combine_icp):
    s = scene
    scale = 0.2

    def scale_fn(icp_res, feat_res, wp):
        return jnp.ones_like(icp_res) * scale

    args = ("x0", "x1", "invD0", "invD1", "K", "s0", "s1")
    ref = jtr.tr_uic_residual(tuple(_j(s["R"], s["t"])), *_j(*(s[k] for k in args)),
                              depth0=jnp.asarray(s["d0"]), depth1=jnp.asarray(s["d1"]),
                              scale_fn=scale_fn, remove_tru_sigma=True,
                              combine_icp=combine_icp)
    w_icp = torch.full((B, 1, H, W), scale)
    got = ttr.tr_uic_residual(tuple(_t(s["R"], s["t"])), *_t(*(s[k] for k in args)),
                              depth0=torch.from_numpy(s["d0"]), depth1=torch.from_numpy(s["d1"]),
                              scale_fn=(lambda *_: w_icp) if combine_icp else None,
                              remove_tru_sigma=True)
    _close(got, ref)


def test_tr_ic_ufc_icp_residuals_match_jax(scene):
    s = scene
    pose_j, pose_t = tuple(_j(s["R"], s["t"])), tuple(_t(s["R"], s["t"]))

    def huber(res, *_):  # the Huber weights, min(1, 0.02 / |r|)
        return jnp.minimum(1.0, 0.02 / jnp.abs(res))

    def huber_t(res, *_):
        return torch.clamp(0.02 / res.abs(), max=1.0)

    ic = ("x0", "x1", "invD0", "invD1", "K")
    _close(ttr.tr_ic_residual(pose_t, *_t(*(s[k] for k in ic)), huber_t),
           jtr.tr_ic_residual(pose_j, *_j(*(s[k] for k in ic)), huber))
    ufc = ("x0", "x1", "d0", "d1", "K", "s0", "s1")
    _close(ttr.tr_ufc_residual(pose_t, *_t(*(s[k] for k in ufc))),
           jtr.tr_ufc_residual(pose_j, *_j(*(s[k] for k in ufc))))
    icp = ("d0", "d1", "K")
    _close(ttr.tr_icp_residual(pose_t, *_t(*(s[k] for k in icp))),
           jtr.tr_icp_residual(pose_j, *_j(*(s[k] for k in icp))))


def _variables(preset, ins):
    net = JaxTracker(cfg=jp.get_preset(preset))
    return jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)


@pytest.fixture(scope="module")
def weights(scene):
    ins = _j(*(scene[k] for k in ("img0", "img1", "d0", "d1", "K")))
    return {p: _variables(p, ins) for p in ("feature", "DeepIC")}


CASES = [  # (preset, overrides, the flax variables, level)
    ("feature", (), "feature", 0),
    ("feature", (), "feature", 2),
    ("feature_icp", (), "feature", 1),
    ("feature", ("direction=forward",), "feature", 0),
    ("DeepIC", (), "DeepIC", 1),
    ("ICP", (), None, 3),
]


@pytest.mark.parametrize("preset,overrides,params,level", CASES)
def test_compute_residual_matches_jax(scene, weights, preset, overrides, params, level):
    s = scene
    ins = ("img0", "img1", "d0", "d1", "K")
    variables = weights[params] if params else {}
    net = JaxTracker(cfg=jp.apply_overrides(jp.get_preset(preset), list(overrides)))
    fn = jax.jit(lambda v, R, t, *a: net.apply(v, *a, pose_init=(R, t), level=level,
                                               method=JaxTracker.compute_residual))
    (R_j, _), ref = fn(variables, *_j(s["R"], s["t"]), *_j(*(s[k] for k in ins)))
    port = LeastSquareTracking(apply_overrides(get_preset(preset), overrides))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(variables))), strict=True)
    with torch.inference_mode():
        (R, _), got = port.compute_residual(*_t(*(s[k] for k in ins)),
                                            pose_init=tuple(_t(s["R"], s["t"])), level=level)
    np.testing.assert_array_equal(R.numpy(), np.asarray(R_j))
    _close(got, ref)


def test_pose_init_replaces_the_initial_pose(scene):
    ins = _t(*(scene[k] for k in ("img0", "img1", "d0", "d1", "K")))
    net = LeastSquareTracking(get_preset("feature")).reset_parameters(1)
    with torch.inference_mode():
        predicted = net._preprocess(*ins[:4])[-1]
        R, t = net(*ins)
        R_p, t_p = net(*ins, pose_init=predicted)
        R_i, t_i = net(*ins, pose_init=tuple(_t(scene["R"], scene["t"])))
    torch.testing.assert_close(R_p, R, rtol=0, atol=0)
    torch.testing.assert_close(t_p, t, rtol=0, atol=0)
    assert (t_i - t).abs().max() > 1e-4
    # object masks: all-object masks change nothing, a partial one does
    with torch.inference_mode():
        _, plain = net.compute_residual(*ins, pose_init=(R_i, t_i))
        whole = torch.ones_like(ins[2], dtype=torch.bool)
        _, masked = net.compute_residual(*ins, pose_init=(R_i, t_i), obj_mask0=whole,
                                         obj_mask1=whole)
        part = whole.clone()
        part[..., : part.shape[-1] // 2] = False
        _, half = net.compute_residual(*ins, pose_init=(R_i, t_i), obj_mask0=part)
    torch.testing.assert_close(masked, plain, rtol=0, atol=0)
    assert (half - plain).abs().max() > 1e-6


# ----------------------------------------------------------------- the basin


def _save_pil(path, array):
    Image.fromarray(array.astype(np.int32), mode="I").convert("I;16").save(path) \
        if array.dtype == np.uint16 else Image.fromarray(array).save(path)


@pytest.fixture(scope="module")
def basin_item(tmp_path_factory):
    seq = str(tmp_path_factory.mktemp("tum") / "seq")
    write_tum_sequence(seq, n=5, save=_save_pil)
    return seq, load_data("TUM_RGBD", [1], "test", select_traj=seq, image_resize=0.1, root="")[1]


@pytest.mark.parametrize("dimension,levels", [("1D", (0, 3)), ("2D", (1, 2))])
def test_evaluate_basin_matches_jax(basin_item, weights, dimension, levels, monkeypatch):
    _, item = basin_item
    T = item["transform"]
    variables = weights["feature"]
    with jax.enable_x64(False):
        net = JaxTracker(cfg=jp.get_preset("feature"))
        make = {"1D": jcb.perturbation_poses_1d, "2D": jcb.perturbation_poses_2d}[dimension]
        poses_j, offsets_j = make(T[:3, :3], T[:3, 3], 0.15, 3)
        ref = jcb.evaluate_basin(net, variables, item, poses_j, levels=levels, chunk=4)
    make = {"1D": pcb.perturbation_poses_1d, "2D": pcb.perturbation_poses_2d}[dimension]
    poses, offsets = make(T[:3, :3], T[:3, 3], 0.15, 3)
    np.testing.assert_array_equal(offsets, offsets_j)
    for a, b in zip(poses, poses_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)
    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(variables))), strict=True)
    calls = []
    gather = tw.gather_twohot
    monkeypatch.setattr(tw, "gather_twohot", lambda *a: calls.append(1) or gather(*a))
    got = pcb.evaluate_basin(port, item, poses, levels=levels, chunk=4, device="cpu")
    assert got.shape == ref.shape == (2,) + tuple(poses[0].shape[:-2])
    n_chunks = -(-int(np.prod(poses[0].shape[:-2])) // 4)
    assert len(calls) == n_chunks * len(levels)  # one K1 a chunk and level
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


def test_convergence_basin_cli(basin_item, tmp_path):
    seq, _ = basin_item
    out = str(tmp_path / "cb.pkl")
    assert pcb.main(["--data_root", "", "--trajectory", seq, "--cb_dimension", "1D",
                     "--pert_samples", "3", "--image_resize", "0.1", "--output", out,
                     "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        data = pickle.load(f)
    assert set(data) == {"costs", "offsets", "dimension", "pert_range", "trajectory",
                         "frame", "keyframe"}
    assert data["costs"].shape == (4, 6, 3) and np.isfinite(data["costs"]).all()
    # the cost is lowest at the ground truth on each axis at level 0
    assert (data["costs"][0].argmin(axis=1) == 1).sum() >= 4
