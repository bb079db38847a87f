"""PyTorch port vs the JAX package: the rest of ``lie.py`` (the 24 euler
conventions both ways, quaternions, the SO(3) log map, the SE(3) exp, log
and adjoint, the 4x4 form), ``warp.py::transform_xyz_jacobian``, and the
helpers with no caller in the tracker: ``grad_bilinear_interpolation``,
``batch_warp_affine``, the planes under 2x2, ``compose_residuals``,
``warp_images``, ``solve_chol_unrolled`` and ``solve_inverse``.

Inputs are numpy arrays from a seed, fed to both packages in float32 (the
conftest turns on JAX's x64, so JAX arrays are cast explicitly) unless a
case says float64.  Tolerance: atol 1e-6 in float32 unless stated, 1e-12
in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import lie as tl
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.ops import kernels as tk
from deep_prob_feature_track_torch.ops import solver6 as ts
from deep_prob_feature_track_torch.solvers import residuals as tr
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.ops import solver6 as js
from deep_prob_feature_track_tpu.solvers import residuals as jr

torch.set_num_threads(2)
ATOL = 1e-6
ATOL64 = 1e-12
AXES = sorted(jl._EULER_AXES)


def f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


def test_all_24_conventions_are_ported():
    assert sorted(tl._EULER_AXES) == AXES and len(AXES) == 24
    assert tl._EULER_AXES == jl._EULER_AXES


@pytest.mark.parametrize("axes", AXES)
def test_euler_to_matrix_matches_jax(rng, axes):
    a = f32(rng, 3, 16, scale=1.2)
    close(tl.euler_to_matrix(*_t(*a), axes=axes), jl.euler_to_matrix(*_j(*a), axes=axes))


@pytest.mark.parametrize("axes", AXES)
def test_matrix_to_euler_matches_jax(rng, axes):
    """Random rotations in float32, and the gimbal lock in float64 (the
    middle angle's sine or cosine exactly 0 up to rounding: the float32
    rounding of pi/2 leaves a cosine of 4e-8, above the 1e-8 threshold)."""
    M = np.asarray(jl.euler_to_matrix(*_j(*f32(rng, 3, 16, scale=1.2)), axes=axes))
    for got, ref in zip(tl.matrix_to_euler(torch.from_numpy(M), axes),
                        jl.matrix_to_euler(jnp.asarray(M), axes)):
        close(got, ref, atol=2e-6)
    repetition = jl._EULER_AXES[axes][2]
    mid = 0.0 if repetition else np.pi / 2
    ai, ak = rng.uniform(-1, 1, (2, 4))
    a = (ai, np.full(4, mid), ak)
    M = np.asarray(jl.euler_to_matrix(*_j(*a), axes=axes))
    out_t = tl.matrix_to_euler(torch.from_numpy(M), axes)
    out_j = jl.matrix_to_euler(jnp.asarray(M), axes)
    for got, ref in zip(out_t, out_j):
        close(got, ref, atol=ATOL64)
    # the degenerate branch: the same rotation back, with a zero third angle
    np.testing.assert_allclose(
        tl.euler_to_matrix(*out_t, axes=axes).numpy(), M, atol=1e-12)


def test_quat_to_matrix_and_pose_vec_quat(rng):
    q = f32(rng, 6, 3, scale=0.4)
    close(tl.quat_to_matrix(torch.from_numpy(q)), jl.quat_to_matrix(jnp.asarray(q)))
    vec = f32(rng, 5, 6, scale=0.3)
    for got, ref in zip(tl.pose_vec_to_Rt(torch.from_numpy(vec), "quat"),
                        jl.pose_vec_to_Rt(jnp.asarray(vec), "quat")):
        close(got, ref)
    with pytest.raises(ValueError, match="rotation mode"):
        tl.pose_vec_to_Rt(torch.from_numpy(vec), "axis_angle")


def _rotations(rng, angles):
    axis = rng.randn(len(angles), 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    return np.asarray(jl.exp_so3(jnp.asarray(axis * np.asarray(angles)[:, None])))


def test_log_so3_matches_jax(rng):
    """Random angles in float32; the identity, 1e-5, and angles within
    1e-3 and 1e-6 of pi in float64 (the cosine clip at -1 + 1e-7)."""
    R = _rotations(rng, rng.uniform(0.0, 3.0, 8)).astype(np.float32)
    close(tl.log_so3(torch.from_numpy(R)), jl.log_so3(jnp.asarray(R)), atol=2e-6)
    R = _rotations(rng, [0.0, 1e-5, np.pi - 1e-3, np.pi - 1e-6, np.pi])
    got = tl.log_so3(torch.from_numpy(R))
    close(got, jl.log_so3(jnp.asarray(R)), atol=ATOL64)
    assert torch.isfinite(got).all()


def test_se3_exp_log_adjoint(rng):
    xi = f32(rng, 6, 6, scale=0.5)
    xi[0] = 0.0  # the small-angle branches
    xi[1, :3] = 1e-5
    for got, ref in zip(tl.exp_se3(torch.from_numpy(xi)), jl.exp_se3(jnp.asarray(xi))):
        close(got, ref)
    R, t = (np.asarray(a) for a in jl.exp_se3(jnp.asarray(xi)))
    close(tl.log_se3(*_t(R, t)), jl.log_se3(*_j(R, t)), atol=3e-6)
    close(tl.adjoint_se3(*_t(R, t)), jl.adjoint_se3(*_j(R, t)))
    # log inverts exp away from the small-angle branches
    close(tl.log_se3(*tl.exp_se3(torch.from_numpy(xi[2:]))), xi[2:], atol=5e-6)


def test_matrix4_round_trip(rng):
    R = _rotations(rng, rng.uniform(0, 3, 4)).astype(np.float32)
    t = f32(rng, 4, 3)
    T = tl.transform_to_matrix4(*_t(R, t))
    close(T, jl.transform_to_matrix4(*_j(R, t)))
    for got, ref in zip(tl.matrix4_to_Rt(T), (R, t)):
        close(got, ref, atol=0.0)


def test_transform_xyz_jacobian_matches_jax(rng):
    xyz = f32(rng, 2, 3, 5, 7)
    R = _rotations(rng, [0.3, 1.1]).astype(np.float32)
    got = tw.transform_xyz_jacobian(*_t(xyz, R))
    assert got.shape == (2, 35, 3, 6)
    close(got, jw.transform_xyz_jacobian(*_j(xyz, R)))


def _uv(rng, b, h, w, H, W):
    """Coordinates over and around an H x W plane, some exactly on cells."""
    u = rng.uniform(-2.0, W + 1.0, (b, 1, h, w)).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, (b, 1, h, w)).astype(np.float32)
    u[0, 0, 0, :3] = [0.0, 1.0, W - 1.0]
    v[0, 0, 0, :3] = [0.0, 1.0, H - 1.0]
    return u, v


def test_grad_bilinear_interpolation_matches_jax(rng):
    F = f32(rng, 2, 3, 9, 11)
    u, v = _uv(rng, 2, 4, 6, 9, 11)
    u[1, 0, 0, 0] = np.nan
    for got, ref in zip(tw.grad_bilinear_interpolation(*_t(F, u, v)),
                        jw.grad_bilinear_interpolation(*_j(F, u, v))):
        if got.dtype == torch.bool:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            close(got, ref)


def test_batch_warp_affine_matches_jax(rng):
    pu, pv = f32(rng, 2, 1, 4, 5), f32(rng, 2, 1, 4, 5)
    for shape in ((2, 2, 3), (2, 3, 3)):
        A = f32(rng, *shape)
        for got, ref in zip(tw.batch_warp_affine(*_t(pu, pv, A)),
                            jw.batch_warp_affine(*_j(pu, pv, A))):
            close(got, ref)


@pytest.mark.parametrize("H,W", [(1, 7), (6, 1), (1, 1)])
def test_planes_under_2x2_match_jax(rng, H, W):
    """A plane where no 2x2 cell fits is sampled in tensor ops, as the JAX
    package samples it away from its kernels; its gradients (autograd here,
    JAX's autodiff there) agree; the kernels' wrappers still refuse it."""
    op = f32(rng, 2, H, W, 3)
    u, v = _uv(rng, 2, 3, 4, H, W)
    ref = jw._bilinear_gather_cl(*_j(op, u, v))
    for plain in (False, True):
        got = tw.warp_operand(torch.from_numpy(op), [2, 1], *_t(u, v), plain=plain)
        close(torch.cat(got, 1).reshape(2, 3, -1), ref)
    opt, ut, vt = (x.requires_grad_() for x in _t(op, u, v))
    (torch.cat(tw.warp_operand(opt, [3], ut, vt), 1) ** 2).sum().backward()
    grads = jax.grad(lambda *a: (jw._bilinear_gather_cl(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *_j(op, u, v))
    for got, ref in zip((opt.grad, ut.grad, vt.grad), grads):
        close(got, ref, atol=1e-5)
    args = tw._corner_weights(op.shape, *_t(u, v))
    with pytest.raises(ValueError, match="2x2"):
        tk.gather_twohot(torch.from_numpy(op), *args)


def test_compose_residuals_matches_jax(rng):
    B, C, H, W = 2, 4, 9, 11
    f0, f1 = f32(rng, B, C, H, W), f32(rng, B, C, H, W)
    s0 = np.abs(f32(rng, B, 1, H, W)) + 0.1
    s1 = np.abs(f32(rng, B, 1, H, W)) + 0.1
    s0[0, 0, 0, 0] = s0.max() + 1.0  # a truncated sigma at its max
    u, v = _uv(rng, B, H, W, H, W)
    invalid = rng.rand(B, 1, H, W) > 0.8
    for remove in (False, True):
        got = tr.compose_residuals(*_t(u, v, invalid, f0, f1, s0, s1), remove_tru_sigma=remove)
        ref = jr.compose_residuals(*_j(u, v, invalid, f0, f1, s0, s1), remove_tru_sigma=remove)
        for g, r in zip(got, ref):
            close(g, r)


def test_warp_images_matches_jax(rng):
    B, H, W = 2, 12, 16
    img1 = f32(rng, B, 3, H, W)
    invD0 = rng.uniform(0.3, 1.0, (B, 1, H, W)).astype(np.float32)
    invD1 = rng.uniform(0.3, 1.0, (B, 1, H, W)).astype(np.float32)
    R = _rotations(rng, [0.02, 0.05]).astype(np.float32)
    t = f32(rng, B, 3, scale=0.05)
    K = np.tile([[14.0, 14.0, 7.5, 5.5]], (B, 1)).astype(np.float32)
    got = tr.warp_images(torch.from_numpy(invD0), _t(R, t), *_t(img1, invD1, K))
    ref = jr.warp_images(jnp.asarray(invD0), _j(R, t), *_j(img1, invD1, K))
    for g, r in zip(got, ref):
        close(g, r, atol=2e-6)


def test_unrolled_and_inverse_solves_match_jax(rng):
    A = rng.randn(5, 6, 6)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    rhs = f32(rng, 5, 6, 1)
    for shape_rhs in (rhs, rhs[..., 0]):
        for fn_t, fn_j in ((ts.solve_chol_unrolled, js.solve_chol_unrolled),
                           (ts.solve_inverse, js.solve_inverse)):
            got, ref = fn_t(*_t(H, shape_rhs)), fn_j(*_j(H, shape_rhs))
            assert got.shape == ref.shape
            close(got, ref, atol=2e-4)
            close(got, ts.solve_chol(*_t(H, shape_rhs)), atol=2e-4)
