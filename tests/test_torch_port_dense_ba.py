"""PyTorch port vs the JAX package: the dense feature-metric window
refinement (``parallel/dense_ba.py``).

Input: the JAX package's textured-plane window (its
``tests/test_dense_ba.py::render_window``, copied here): 4 frames of 48x64,
one feature channel, unit sigma, poses 0.02 rad / 5 cm apart from a seed,
the initial poses perturbed by 0.01 from a seed; edges span 2 frames.

The float64 cases take the kernels' plain versions (``plain=True``): the
kernel wrappers take float32 alone.

Tolerances:

- float64 (the frames and poses cast from the float32 render):
  ``edge_linearization``'s JtWJ, JtR and cost within 1e-10 of their largest
  entry, ``_assemble`` within 1e-10, ``refine_dense_window``'s poses and
  costs within 1e-8 (absolute on poses, relative on costs);
- float32: the JAX float32 run's own distance from the float64 one is the
  envelope (the watch list's rule for chains of Gauss-Newton solves): the
  port's float32 poses stay within ``2 * envelope + 1e-6`` of the JAX
  float32 ones and within the same of float64; measured here, the
  envelope is 6.7e-7 and the port's float32 poses 1.5e-7 from the JAX
  float32 ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.parallel import dense_ba as pdb
from deep_prob_feature_track_tpu.geometry import lie, warp
from deep_prob_feature_track_tpu.parallel import dense_ba as jdb

torch.set_num_threads(2)


def field(x, y):
    return (
        jnp.sin(x * 14.0) * jnp.cos(y * 11.0)
        + 0.6 * jnp.sin(x * 5.0 + 1.0)
        + 0.4 * jnp.cos(y * 7.0 + 0.5)
    )


def render_window(rng, n_frames=4, H=48, W=64, plane_z=2.0):
    """Intensity and depth of a textured world plane seen from n poses
    (world frame = camera 0), as the JAX package's dense BA test renders
    them: ``(WindowFrames, poses_gt [N,4,4])``."""
    K = jnp.asarray(
        np.tile([[0.8 * W, 0.8 * W, (W - 1) / 2.0, (H - 1) / 2.0]], (n_frames, 1)),
        jnp.float32,
    )
    poses = [np.eye(4)]
    for _ in range(n_frames - 1):
        xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.05, 0.05, 3)])
        dR, dt = lie.exp_se3(jnp.asarray(xi[None]))
        T = np.eye(4)
        T[:3, :3] = np.asarray(dR)[0]
        T[:3, 3] = np.asarray(dt)[0]
        poses.append(poses[-1] @ T)
    poses = np.stack(poses).astype(np.float32)

    px, py = warp.generate_xy_grid(n_frames, H, W, K)
    dirs = jnp.concatenate([px, py, jnp.ones_like(px)], axis=1)  # [N,3,H,W]
    R_wc = jnp.asarray(poses[:, :3, :3])
    t_wc = jnp.asarray(poses[:, :3, 3])
    rdz = jnp.einsum("nj,njhw->nhw", R_wc[:, 2, :], dirs)[:, None]
    z = (plane_z - t_wc[:, 2][:, None, None, None]) / rdz  # cam depth
    Xw = warp.batch_transform_xyz(dirs * z, R_wc, t_wc)
    feats = field(Xw[:, 0:1], Xw[:, 1:2]).astype(jnp.float32)
    frames = jdb.WindowFrames(
        feats=feats,
        sigmas=jnp.ones_like(feats),
        invD=(1.0 / z).astype(jnp.float32),
        K=K,
    )
    return frames, poses


def perturb(poses, rng, scale=0.01):
    out = poses.copy()
    for k in range(1, len(poses)):
        xi = rng.randn(6).astype(np.float32) * scale
        dR, dt = lie.exp_se3(jnp.asarray(xi[None]))
        D = np.eye(4, dtype=np.float32)
        D[:3, :3] = np.asarray(dR)[0]
        D[:3, 3] = np.asarray(dt)[0]
        out[k] = out[k] @ D
    return out


def window_edges(n, span=2):
    pairs = [(i, j) for i in range(n) for j in range(i + 1, min(i + span + 1, n))]
    return np.asarray([p[0] for p in pairs]), np.asarray([p[1] for p in pairs])


@pytest.fixture(scope="module")
def window():
    rng = np.random.RandomState(0)
    frames, poses_gt = render_window(rng)
    frames = jdb.WindowFrames(*(np.asarray(x) for x in frames))
    return frames, poses_gt, perturb(poses_gt, rng)


def _cast(window, dtype, poses=None, varied_sigma=False):
    """The window's frames, poses and edges for both packages in ``dtype``;
    with ``varied_sigma`` the sigma map is ``0.5 + feats^2`` instead of
    ones (its gradients then enter the Jacobian, and ``remove_tru_sigma``
    masks the pixels at its extremes over all edges, not all of them)."""
    frames, poses_gt, poses_init = window
    poses = poses_init if poses is None else poses
    if varied_sigma:
        frames = frames._replace(sigmas=0.5 + frames.feats ** 2)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    ei, ej = window_edges(len(poses))
    jax_args = (jdb.WindowFrames(*(jnp.asarray(x.astype(np_dtype)) for x in frames)),
                jnp.asarray(poses[:, :3, :3].astype(np_dtype)),
                jnp.asarray(poses[:, :3, 3].astype(np_dtype)),
                jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32))
    port_args = (pdb.WindowFrames(*(torch.from_numpy(x.astype(np_dtype)) for x in frames)),
                 torch.from_numpy(poses[:, :3, :3].astype(np_dtype)),
                 torch.from_numpy(poses[:, :3, 3].astype(np_dtype)),
                 torch.from_numpy(ei), torch.from_numpy(ej))
    return jax_args, port_args


def _rel(R, t, ei, ej, mod):
    return mod.compose(*mod.inverse(R[ej], t[ej]), R[ei], t[ei])


def _mat4(R, t):
    T = np.tile(np.eye(4), (len(R), 1, 1))
    T[:, :3, :3], T[:, :3, 3] = np.asarray(R), np.asarray(t)
    return T


@pytest.mark.parametrize("remove_tru_sigma", [False, True])
def test_edge_linearization_and_assemble_match_jax(window, remove_tru_sigma):
    """Float64, on the varied sigma; with ``remove_tru_sigma`` the sigma
    truncation reduces over all edges (a per-edge one would mask each
    edge's own extremes)."""
    from deep_prob_feature_track_torch.geometry import lie as tl

    (jf, jR, jt, jei, jej), (pf, pR, pt, pei, pej) = _cast(window, torch.float64,
                                                           varied_sigma=True)
    jRr, jtr = _rel(jR, jt, jei, jej, lie)
    pRr, ptr = _rel(pR, pt, pei, pej, tl)
    ref = jdb.edge_linearization(jf, jei, jej, jRr, jtr, remove_tru_sigma)
    got = pdb.edge_linearization(pf, pei, pej, pRr, ptr, remove_tru_sigma, plain=True)
    for name, g, r in zip(("JtWJ", "JtR", "cost"), got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float64 and g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-10 * np.abs(r).max(), rtol=0,
                                   err_msg=name)
    H, b = pdb._assemble(pRr, ptr, pei, pej, got[0], got[1], 4)
    jH, jb = (np.asarray(x) for x in jdb._assemble(jRr, jtr, jei, jej, ref[0], ref[1], 4))
    np.testing.assert_allclose(H.numpy(), jH, atol=1e-10 * np.abs(jH).max(), rtol=0)
    np.testing.assert_allclose(b.numpy(), jb, atol=1e-10 * np.abs(jb).max(), rtol=0)
    assert H.shape == (24, 24) and b.shape == (24,)


@pytest.mark.parametrize("remove_tru_sigma", [False, True])
def test_refine_dense_window_matches_jax_float64(window, remove_tru_sigma):
    (jf, jR, jt, jei, jej), (pf, pR, pt, pei, pej) = _cast(window, torch.float64,
                                                           varied_sigma=True)
    kw = dict(iterations=4, remove_tru_sigma=remove_tru_sigma)
    R, t, costs = pdb.refine_dense_window(pf, pR, pt, pei, pej, plain=True, **kw)
    jRo, jto, jcosts = jdb.refine_dense_window(jf, jR, jt, jei, jej, **kw)
    np.testing.assert_allclose(_mat4(R, t), _mat4(jRo, jto), atol=1e-8, rtol=0)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-8)
    assert costs.shape == (4,) and float(costs[-1]) < float(costs[0])
    # the window moved towards the ground truth
    poses_gt = window[1]
    err0 = np.abs(window[2][:, :3, 3] - poses_gt[:, :3, 3]).max()
    assert np.abs(_mat4(R, t)[:, :3, 3] - poses_gt[:, :3, 3]).max() < 0.5 * err0


def test_refine_dense_window_float32(window):
    """The port's float32 run against the JAX float32 and float64 runs,
    within the envelope the JAX float32 run sets."""
    jax64, port64 = _cast(window, torch.float64)
    jax32, port32 = _cast(window, torch.float32)
    ref64 = _mat4(*jdb.refine_dense_window(*jax64, iterations=4)[:2])
    jR, jt, jcosts = jdb.refine_dense_window(*jax32, iterations=4)
    R, t, costs = pdb.refine_dense_window(*port32, iterations=4)
    assert R.dtype == torch.float32 and costs.dtype == torch.float32
    ref32, got = _mat4(jR, jt), _mat4(R, t)
    envelope = np.abs(ref32 - ref64).max()
    assert envelope < 1e-4, envelope
    bound = 2 * envelope + 1e-6
    np.testing.assert_allclose(got, ref32, atol=bound, rtol=0)
    np.testing.assert_allclose(got, ref64, atol=bound, rtol=0)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-4)


def test_zero_weight_padding_edges(window):
    """Edges padded with weight 0 (copies of the first) leave the poses and
    costs as they were, as in the JAX function."""
    (jf, jR, jt, jei, jej), (pf, pR, pt, pei, pej) = _cast(window, torch.float64)
    pad = 3
    pei_p = torch.cat([pei, pei[:1].repeat(pad)])
    pej_p = torch.cat([pej, pej[:1].repeat(pad)])
    w = torch.cat([torch.ones(len(pei)), torch.zeros(pad)]).double()
    R, t, costs = pdb.refine_dense_window(pf, pR, pt, pei_p, pej_p, edge_weights=w,
                                          iterations=3, plain=True)
    R0, t0, costs0 = pdb.refine_dense_window(pf, pR, pt, pei, pej, iterations=3, plain=True)
    np.testing.assert_allclose(_mat4(R, t), _mat4(R0, t0), atol=1e-12, rtol=0)
    np.testing.assert_allclose(costs.numpy(), costs0.numpy(), rtol=1e-12)
    jRo, jto, jcosts = jdb.refine_dense_window(
        jf, jR, jt, jnp.asarray(pei_p.numpy(), jnp.int32), jnp.asarray(pej_p.numpy(), jnp.int32),
        edge_weights=jnp.asarray(w.numpy()), iterations=3)
    np.testing.assert_allclose(_mat4(R, t), _mat4(jRo, jto), atol=1e-8, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ground_truth_is_a_fixed_point(window, dtype):
    """From the ground truth the residuals are ~0 and ``log_se3`` of the
    near-identity relative errors stays finite; the rendered frames'
    interpolation bias moves the poses a few mm at most, as in the JAX
    package's test."""
    poses_gt = window[1]
    (jf, jR, jt, jei, jej), port = _cast(window, dtype, poses=poses_gt)
    R, t, costs = pdb.refine_dense_window(*port, iterations=3, plain=dtype == torch.float64)
    assert torch.isfinite(costs).all() and torch.isfinite(R).all() and torch.isfinite(t).all()
    got = _mat4(R, t)
    assert np.abs(got[:, :3, 3] - poses_gt[:, :3, 3]).max() < 6e-3
    if dtype == torch.float64:
        ref = _mat4(*jdb.refine_dense_window(jf, jR, jt, jei, jej, iterations=3)[:2])
        np.testing.assert_allclose(got, ref, atol=1e-8, rtol=0)


def test_mesh_of_one_rank_is_the_refinement(window):
    """On a mesh of one rank the sharded window gives the unsharded one's
    bits (two ranks against the JAX mesh: ``test_torch_port_dist.py``)."""
    from deep_prob_feature_track_torch.parallel import mesh as pmesh

    _, port = _cast(window, torch.float64)
    mesh = pmesh.make_mesh("cpu")
    try:
        got = pdb.refine_dense_window(*port, iterations=2, plain=True, mesh=mesh)
        ref = pdb.refine_dense_window(*port, iterations=2, plain=True)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        with pytest.raises(ValueError, match="multiple of"):
            pdb.refine_dense_window(*port, plain=True, mesh=pmesh.Mesh(
                None, 0, 1 + port[3].shape[0], torch.device("cpu")))
    finally:
        pmesh.destroy()
