"""PyTorch port vs the JAX package: the pose-graph back end
(``parallel/ba.py``).

Inputs: a random-walk window of 8 poses from a seed, odometry edges and two
loop closures with exact measurements ``T_j^{-1} T_i``, the initial poses
perturbed by 0.05 (twist units) from a seed, and random symmetric positive
definite information matrices (``A A^T + I``, entries ~10).

Tolerances:

- float64: residuals, H, b, cost, the refined poses and every iteration's
  cost within 1e-10 (of the largest entry for H, relative for the cost);
- float32: each package's float32 result is held to the float64 one, and
  the two float32 results to each other, within ``F32_POSE = 1e-5`` on
  poses: the 6N system's anchor (1e6) against the information entries
  (~10) conditions the solve to ~1e5, so one float32 rounding (6e-8)
  moves a step by up to ~1e-5 of its size, and the 0.05 step shrinks
  quadratically after the first iteration; residuals 1e-5, H and b within
  1e-5 of their largest entry, costs 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.parallel import ba as pba
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.parallel import ba as jba

torch.set_num_threads(2)
N = 8
F32_POSE = 1e-5
F32_REL = 1e-5


def _exp(xi):
    R, t = jl.exp_se3(jnp.asarray(np.asarray(xi, np.float64)[None]))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = np.asarray(R)[0], np.asarray(t)[0]
    return T


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(3)
    poses_gt = [np.eye(4)]
    for _ in range(N - 1):
        poses_gt.append(poses_gt[-1] @ _exp(np.concatenate([rng.randn(3) * 0.1,
                                                            rng.randn(3) * 0.3])))
    poses_gt = np.stack(poses_gt)
    pairs = [(i, i + 1) for i in range(N - 1)] + [(0, N - 1), (0, N // 2)]
    meas = []
    for i, j in pairs:
        Tij = np.linalg.inv(poses_gt[j]) @ poses_gt[i]
        meas.append((Tij[:3, :3], Tij[:3, 3]))
    poses_init = poses_gt.copy()
    for k in range(1, N):
        poses_init[k] = poses_init[k] @ _exp(rng.randn(6) * 0.05)
    A = rng.randn(len(pairs), 6, 6)
    infos = list(np.einsum("eij,ekj->eik", A, A) + np.eye(6))
    return poses_gt, poses_init, pairs, meas, infos


def _graphs(problem, dtype, infos=True, poses=None):
    _, poses_init, pairs, meas, inf = problem
    poses = poses_init if poses is None else poses
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    cast = [(R.astype(np_dtype), t.astype(np_dtype)) for R, t in meas]
    inf = [i.astype(np_dtype) for i in inf] if infos else None
    jg = jba.build_window_graph(poses.astype(np_dtype), pairs, cast, inf)
    pg = pba.build_window_graph(poses.astype(np_dtype), pairs, cast, inf, device="cpu")
    return jg, pg


def _mat4(R, t):
    T = np.tile(np.eye(4), (len(R), 1, 1))
    T[:, :3, :3], T[:, :3, 3] = np.asarray(R), np.asarray(t)
    return T


def test_build_window_graph_matches_jax(problem):
    jg, pg = _graphs(problem, torch.float64)
    for name in jba.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(pg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert pg.edges_i.dtype == torch.int64 and pg.R.dtype == torch.float64
    # meas and infos of another dtype follow the poses, or the dtype asked for
    _, poses_init, pairs, meas, infos = problem
    g32 = pba.build_window_graph(poses_init, pairs, [(R.astype(np.float32), t) for R, t in meas],
                                 device="cpu", dtype=torch.float32)
    assert g32.info is None and {g32.R.dtype, g32.meas_R.dtype} == {torch.float32}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, F32_REL)])
def test_edge_residuals_and_system_match_jax(problem, dtype, tol):
    jg, pg = _graphs(problem, dtype)
    r = pba.edge_residuals(pg).numpy()
    np.testing.assert_allclose(r, np.asarray(jba.edge_residuals(jg)), atol=tol, rtol=0)
    assert np.abs(r).max() > 1e-2  # the perturbed poses miss their measurements
    H, b, cost = pba._edge_system(pg, pg.edges_i, pg.edges_j, pg.meas_R, pg.meas_t, pg.info)
    jH, jb, jcost = jba._edge_system(jg, jg.edges_i, jg.edges_j, jg.meas_R, jg.meas_t, jg.info)
    jH, jb = np.asarray(jH), np.asarray(jb)
    np.testing.assert_allclose(H.numpy(), jH, atol=tol * np.abs(jH).max(), rtol=0)
    np.testing.assert_allclose(b.numpy(), jb, atol=tol * np.abs(jb).max(), rtol=0)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=10 * tol)
    assert H.dtype == dtype and H.shape == (6 * N, 6 * N)
    np.testing.assert_allclose(H.numpy(), H.numpy().T, atol=tol * np.abs(jH).max(), rtol=0)


@pytest.mark.parametrize("infos", [True, False])
def test_refine_pose_graph_matches_jax_float64(problem, infos):
    jg, pg = _graphs(problem, torch.float64, infos=infos)
    got, costs = pba.refine_pose_graph(pg, iterations=6)
    ref, jcosts = jba.refine_pose_graph(jg, iterations=6)
    np.testing.assert_allclose(_mat4(got.R, got.t), _mat4(ref.R, ref.t), atol=1e-10, rtol=0)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-10, atol=1e-18)
    # the costs are those before each update: the first is the initial one
    H, b, c0 = pba._edge_system(pg, pg.edges_i, pg.edges_j, pg.meas_R, pg.meas_t, pg.info)
    assert float(costs[0]) == float(c0) and costs.shape == (6,)
    assert float(costs[-1]) < 1e-12 * float(costs[0])  # exact measurements: converged
    poses_gt = problem[0]
    np.testing.assert_allclose(_mat4(got.R, got.t), poses_gt, atol=1e-9)


def test_refine_pose_graph_float32(problem):
    """Both packages' float32 results against float64 and each other."""
    jg64, pg64 = _graphs(problem, torch.float64)
    jg32, pg32 = _graphs(problem, torch.float32)
    ref64 = _mat4(*pba.refine_pose_graph(pg64, iterations=6)[0][:2])
    got, costs = pba.refine_pose_graph(pg32, iterations=6)
    ref, jcosts = jba.refine_pose_graph(jg32, iterations=6)
    assert got.R.dtype == torch.float32 and costs.dtype == torch.float32
    got, ref = _mat4(got.R, got.t), _mat4(ref.R, ref.t)
    for x in (got, ref):
        np.testing.assert_allclose(x, ref64, atol=F32_POSE, rtol=0)
    np.testing.assert_allclose(got, ref, atol=F32_POSE, rtol=0)
    np.testing.assert_allclose(costs.numpy()[:2], np.asarray(jcosts)[:2], rtol=10 * F32_REL)


def test_information_weighting(problem):
    """An edge whose measurement disagrees with the rest pulls the poses
    by its information: a 1e4-weighted bad loop closure drags the chain,
    a 1e-4-weighted one barely moves it; both as the JAX function."""
    poses_gt, poses_init, pairs, meas, infos = problem
    bad = list(meas)
    k = pairs.index((0, N - 1))
    bad[k] = (meas[k][0], meas[k][1] + np.array([0.3, 0.0, 0.0]))
    moved = []
    for w in (1e4, 1e-4):
        inf = [np.eye(6) for _ in pairs]
        inf[k] = w * np.eye(6)
        pg = pba.build_window_graph(poses_init, pairs, bad, inf, device="cpu")
        jg = jba.build_window_graph(poses_init, pairs, bad, inf)
        got, _ = pba.refine_pose_graph(pg, iterations=8)
        ref, _ = jba.refine_pose_graph(jg, iterations=8)
        got = _mat4(got.R, got.t)
        np.testing.assert_allclose(got, _mat4(ref.R, ref.t), atol=1e-10, rtol=0)
        moved.append(np.abs(got[:, :3, 3] - poses_gt[:, :3, 3]).max())
    assert moved[0] > 0.1 and moved[1] < 1e-3, moved


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ground_truth_is_a_fixed_point(problem, dtype):
    """At the ground truth every residual is ~0: ``log_se3`` of an exact or
    rounded identity stays finite and the poses stay put.  In float64 the
    residuals are ~5e-10, not 0: ``log_so3`` clips the cosine to 1 - 1e-7
    (both packages alike), which moves the poses by 4.9e-10."""
    poses_gt = problem[0]
    jg, pg = _graphs(problem, dtype, poses=poses_gt)
    got, costs = pba.refine_pose_graph(pg, iterations=3)
    assert torch.isfinite(costs).all() and torch.isfinite(got.R).all()
    fixed, agree = (1e-9, 1e-12) if dtype == torch.float64 else (1e-6, 1e-6)
    np.testing.assert_allclose(_mat4(got.R, got.t), poses_gt, atol=fixed, rtol=0)
    ref, jcosts = jba.refine_pose_graph(jg, iterations=3)
    np.testing.assert_allclose(_mat4(got.R, got.t), _mat4(ref.R, ref.t), atol=agree, rtol=0)
    # an exact identity residual (a graph whose measurement is its own pose)
    eye = torch.eye(3, dtype=dtype)[None]
    zero = torch.zeros(1, 3, dtype=dtype)
    g = pba.PoseGraph(eye, zero, torch.tensor([0]), torch.tensor([0]), eye, zero)
    assert torch.equal(pba.edge_residuals(g), torch.zeros(1, 6, dtype=dtype))


def test_scatter_blocks_sums_repeated_edges():
    """Repeated and reversed edges add up as a loop over the edges adds
    them, and two calls give the same bits."""
    g = torch.Generator().manual_seed(0)
    ei = torch.tensor([0, 1, 0, 2, 0])
    ej = torch.tensor([1, 2, 1, 0, 2])
    E, n = 5, 3
    H_ii, H_ij, H_jj = (torch.randn(E, 6, 6, generator=g, dtype=torch.float64)
                        for _ in range(3))
    b_i, b_j = (torch.randn(E, 6, generator=g, dtype=torch.float64) for _ in range(2))
    H, b = pba.scatter_blocks(ei, ej, n, H_ii, H_ij, H_jj, b_i, b_j)
    ref = torch.zeros(n, n, 6, 6, dtype=torch.float64)
    for e in range(E):
        i, j = int(ei[e]), int(ej[e])
        ref[i, i] += H_ii[e]
        ref[i, j] += H_ij[e]
        ref[j, i] += H_ij[e].T
        ref[j, j] += H_jj[e]
    refb = torch.zeros(n, 6, dtype=torch.float64).index_add_(0, ei, b_i).index_add_(0, ej, b_j)
    torch.testing.assert_close(H, ref.permute(0, 2, 1, 3).reshape(6 * n, 6 * n), rtol=0,
                               atol=1e-14)
    torch.testing.assert_close(b, refb.reshape(-1), rtol=0, atol=1e-14)
    again = pba.scatter_blocks(ei, ej, n, H_ii, H_ij, H_jj, b_i, b_j)
    assert torch.equal(H, again[0]) and torch.equal(b, again[1])


def test_sharded_refinement_on_one_rank_is_the_refinement(problem):
    """On a mesh of one rank the sharded refinement gives the unsharded
    one's bits (two ranks: ``test_torch_port_dist.py``); an edge count that
    does not divide over the ranks raises."""
    from deep_prob_feature_track_torch.parallel import mesh as pmesh

    _, pg = _graphs(problem, torch.float64)
    mesh = pmesh.make_mesh("cpu")
    try:
        got, got_costs = pba.refine_pose_graph_sharded(pg, mesh, iterations=4)
        ref, ref_costs = pba.refine_pose_graph(pg, iterations=4)
        assert torch.equal(got.R, ref.R) and torch.equal(got.t, ref.t)
        assert torch.equal(got_costs, ref_costs)
        with pytest.raises(ValueError, match="multiple of 2"):
            pba.refine_pose_graph_sharded(pg, pmesh.Mesh(None, 0, 2, torch.device("cpu")))
    finally:
        pmesh.destroy()
