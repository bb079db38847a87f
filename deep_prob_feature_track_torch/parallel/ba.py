"""Multi-keyframe pose-graph refinement (the windowed BA back end).

Counterpart of ``deep_prob_feature_track_tpu/parallel/ba.py``: given a window of keyframe poses and pairwise relative-pose
constraints from the tracker, each with its 6x6 information matrix (the
U_IC solver's ``JtWJ``, ``uncer_prop``), refine all poses jointly with
Gauss-Newton on SE(3).

Math (twist order [rot, trs], right perturbation ``T <- T exp(delta)``):
edge (i, j) with measurement ``M`` of ``T_j^{-1} T_i`` has the residual
``r = Log(M^{-1} T_j^{-1} T_i)``, ``dr/ddelta_i ~ I`` and ``dr/ddelta_j ~
-Adj(T_i^{-1} T_j)``.

The 6x6 blocks of the edges are summed into the dense ``[6N,6N]`` system
by ``index_put_(..., accumulate=True)`` (:func:`scatter_blocks`), whose
CUDA path sorts the indices and adds the repeated ones in that order
(``index_add_`` adds with atomics): a call gives the same bits on every
run on the card, at work linear in the edges.  The damped solve is
``torch.linalg.solve_ex``: it neither raises nor waits on the host where
the system is singular (its result is then non-finite, as
``jnp.linalg.solve``'s is).

The mesh-sharded refinement (:func:`refine_pose_graph_sharded`) splits the
edges over the ranks of a ``parallel.mesh.Mesh``: every rank builds H, b
and the cost of its slice, the three are summed over the ranks, and the
solve and the update run on every rank alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..geometry.lie import adjoint_se3, compose, exp_se3, inverse, log_se3


class PoseGraph(NamedTuple):
    """A window of keyframe poses and pairwise constraints.

    :param R, t: [N,3,3], [N,3] camera-to-world keyframe poses
    :param edges_i, edges_j: [E] int64 endpoint indices
    :param meas_R, meas_t: [E,...] measured relative poses ``T_j^{-1} T_i``
        (the tracker's pose10 for the pair (template=i, live=j))
    :param info: [E,6,6] information matrices (JtWJ), or None for identity
    """

    R: torch.Tensor
    t: torch.Tensor
    edges_i: torch.Tensor
    edges_j: torch.Tensor
    meas_R: torch.Tensor
    meas_t: torch.Tensor
    info: Optional[torch.Tensor] = None


def edge_residuals(graph: PoseGraph) -> torch.Tensor:
    """Per-edge se(3) residuals [E,6]."""
    Ri, ti = graph.R[graph.edges_i], graph.t[graph.edges_i]
    Rj, tj = graph.R[graph.edges_j], graph.t[graph.edges_j]
    R_rel, t_rel = compose(*inverse(Rj, tj), Ri, ti)  # T_j^{-1} T_i
    R_err, t_err = compose(*inverse(graph.meas_R, graph.meas_t), R_rel, t_rel)
    return log_se3(R_err, t_err)


def scatter_blocks(edges_i, edges_j, n_poses, H_ii, H_ij, H_jj, b_i, b_j):
    """Sum per-edge blocks into the dense system: block (i, i) gets
    ``H_ii``, (i, j) ``H_ij``, (j, i) its transpose, (j, j) ``H_jj``; rows
    i and j of b get ``b_i`` and ``b_j``.  Repeated indices add up, in the
    same order on every call on the card.

    :return: ``(H [6N,6N], b [6N])``
    """
    rows = torch.cat([edges_i, edges_i, edges_j, edges_j])
    cols = torch.cat([edges_i, edges_j, edges_i, edges_j])
    blocks = torch.cat([H_ii, H_ij, H_ij.transpose(-1, -2), H_jj])  # [4E,6,6]
    H = H_ii.new_zeros(n_poses, n_poses, 6, 6).index_put_((rows, cols), blocks, accumulate=True)
    b = b_i.new_zeros(n_poses, 6).index_put_((torch.cat([edges_i, edges_j]),),
                                             torch.cat([b_i, b_j]), accumulate=True)
    return H.permute(0, 2, 1, 3).reshape(n_poses * 6, n_poses * 6), b.reshape(-1)


def _edge_system(graph: PoseGraph, edges_i, edges_j, meas_R, meas_t, info):
    """The H/b contributions of a set of edges.

    :return: ``(H [6N,6N], b [6N], cost scalar)``
    """
    r = edge_residuals(PoseGraph(graph.R, graph.t, edges_i, edges_j, meas_R, meas_t, info))
    Ri, ti = graph.R[edges_i], graph.t[edges_i]
    Rj, tj = graph.R[edges_j], graph.t[edges_j]
    R_ainv, t_ainv = compose(*inverse(Ri, ti), Rj, tj)  # A^{-1} = T_i^{-1} T_j
    eye = torch.eye(6, dtype=r.dtype, device=r.device).expand(r.shape[0], 6, 6)
    J_j = -adjoint_se3(R_ainv, t_ainv)  # [E,6,6]; J_i = I
    lam = info if info is not None else eye

    H_ii = lam  # I^T lam I
    H_ij = lam @ J_j
    H_jj = J_j.transpose(-1, -2) @ lam @ J_j
    lr = torch.einsum("eij,ej->ei", lam, r)
    b_j = torch.einsum("eji,ej->ei", J_j, lr)
    H, b = scatter_blocks(edges_i, edges_j, graph.R.shape[0], H_ii, H_ij, H_jj, lr, b_j)
    return H, b, torch.sum(r * lr)


def _gn_update(graph: PoseGraph, H, b, anchor_weight: float, damping: float) -> PoseGraph:
    n6 = H.shape[0]
    eye = torch.eye(n6, dtype=H.dtype, device=H.device)
    # gauge fix: a strong prior pinning pose 0 at its current value
    anchor = torch.zeros(n6, dtype=H.dtype, device=H.device)
    anchor[:6] = anchor_weight
    H = H + torch.diag(anchor) + damping * eye
    delta = -torch.linalg.solve_ex(H, b[:, None])[0].reshape(-1, 6)
    R_new, t_new = compose(graph.R, graph.t, *exp_se3(delta))  # right-compose
    return graph._replace(R=R_new, t=t_new)


def refine_pose_graph(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> Tuple[PoseGraph, torch.Tensor]:
    """Gauss-Newton refinement on the graph's device.

    :return: ``(refined graph, costs [iterations])``: each cost is the one
        of the poses the iteration started from, before its update
    """
    costs = []
    for _ in range(iterations):
        H, b, cost = _edge_system(graph, graph.edges_i, graph.edges_j, graph.meas_R,
                                  graph.meas_t, graph.info)
        graph = _gn_update(graph, H, b, anchor_weight, damping)
        costs.append(cost)
    return graph, torch.stack(costs)


def refine_pose_graph_sharded(
    graph: PoseGraph,
    mesh,
    iterations: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> Tuple[PoseGraph, torch.Tensor]:
    """:func:`refine_pose_graph` with the edges split over ``mesh``'s
    ranks (a ``parallel.mesh.Mesh``): each rank takes its equal contiguous
    slice of the edges, and H, b and the cost are summed over the ranks
    before the solve, which every rank runs alike.  Every rank passes the
    whole graph; the edge count must divide by the world size (pad with
    zero-information edges).

    :return: ``(refined graph, costs [iterations])``, the same on every rank
    """
    E = graph.edges_i.shape[0]
    if E % mesh.world:
        raise ValueError(f"pad the edges to a multiple of {mesh.world} (E={E})")
    rows = slice(mesh.rank * (E // mesh.world), (mesh.rank + 1) * (E // mesh.world))
    info = graph.info if graph.info is not None else torch.eye(
        6, dtype=graph.R.dtype, device=graph.R.device).expand(E, 6, 6)
    edges = (graph.edges_i[rows], graph.edges_j[rows], graph.meas_R[rows], graph.meas_t[rows],
             info[rows])
    costs = []
    for _ in range(iterations):
        H, b, cost = _edge_system(graph, *edges)
        for x in (H, b, cost):
            dist.all_reduce(x, group=mesh.group)
        graph = _gn_update(graph, H, b, anchor_weight, damping)
        costs.append(cost)
    return graph, torch.stack(costs)


def build_window_graph(poses_WC: np.ndarray, pairs, meas, infos=None, device="cuda",
                       dtype: Optional[torch.dtype] = None) -> PoseGraph:
    """A :class:`PoseGraph` from numpy poses and tracked pair measurements.

    :param poses_WC: [N,4,4] initial camera-to-world poses
    :param pairs: list of (i, j)
    :param meas: list of (R, t) measured ``T_j^{-1} T_i`` per pair
    :param infos: optional list of [6,6] information matrices
    :param device: the card unless ``"cpu"`` is asked for
    :param dtype: the graph's float type; default the poses' own
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.as_tensor(np.asarray(poses_WC)).dtype

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    return PoseGraph(
        R=tensor(poses_WC[:, :3, :3]),
        t=tensor(poses_WC[:, :3, 3]),
        edges_i=torch.as_tensor([p[0] for p in pairs], dtype=torch.int64, device=device),
        edges_j=torch.as_tensor([p[1] for p in pairs], dtype=torch.int64, device=device),
        meas_R=tensor(np.stack([np.asarray(m[0]) for m in meas])),
        meas_t=tensor(np.stack([np.asarray(m[1]) for m in meas])),
        info=None if infos is None else tensor(np.stack([np.asarray(i) for i in infos])),
    )
