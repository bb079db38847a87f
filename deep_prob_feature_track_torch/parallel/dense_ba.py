"""Dense feature-metric multi-keyframe refinement (direct windowed BA).

Counterpart of ``deep_prob_feature_track_tpu/parallel/dense_ba.py``.  Where ``parallel/ba.py`` refines poses against fixed relative-pose
measurements, this back end re-linearizes the dense uncertainty-normalized
feature-metric residual of every window edge at the current poses on each
Gauss-Newton iteration.

Per outer iteration:

1. the relative poses ``T_rel = T_j^{-1} T_i`` of all E edges;
2. one batched U_IC linearization over the edge axis: the frames' maps
   are indexed per edge, warped in one gather (kernel K1, or K4 where
   ``ops/kernels/tiles.py::use_tiles`` routes the plane) and reduced to
   ``(JtWJ [E,6,6], JtR [E,6])`` by K6; on CPU tensors, or with
   ``plain=True``, their plain versions;
3. the chain to the global tangent, ``G_i = I``, ``G_j = -Adj(T_rel^{-1})``
   (right perturbations), summed into the dense ``[6N,6N]`` system by
   ``parallel/ba.py::scatter_blocks``;
4. the anchored damped solve and the update ``T_k <- T_k exp(-xi_k)``: the
   tracker's convention, which solves ``xi = H^{-1} JtR`` and composes
   ``exp(xi)^{-1}``.

The batch of every reduction is the edge axis: with ``remove_tru_sigma``
the sigma truncation takes its min/max over all E edges, zero-weight
padding edges included, as in the JAX package.  With a mesh
(``parallel.mesh.Mesh``) each rank linearizes its equal contiguous slice of
the edges and H, b and the cost are summed over the ranks.  The JAX
package runs that linearization inside ``shard_map``, so there the sigma
truncation's min/max is each shard's own: so it is here, on each rank's
slice (no mesh is active inside the linearization).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..geometry import warp as W
from ..geometry.lie import adjoint_se3, compose, exp_se3, inverse
from ..solvers.jacobians import jtj_jtr, precompute_uic, uic_factors
from ..solvers.residuals import build_inverse_warp_operand, compute_inverse_residuals
from . import mesh as M
from .ba import scatter_blocks


class WindowFrames(NamedTuple):
    """Per-frame maps of the refinement window (stacked on axis 0)."""

    feats: torch.Tensor   # [N,C,H,W]
    sigmas: torch.Tensor  # [N,C,H,W], or [N,1,H,W] for a broadcast sigma
    invD: torch.Tensor    # [N,1,H,W]
    K: torch.Tensor       # [N,4]


def edge_linearization(frames: WindowFrames, edges_i, edges_j, R_rel, t_rel,
                       remove_tru_sigma: bool = False, plain: bool = False):
    """Batched U_IC linearization of all edges at the relative poses
    ``(R_rel, t_rel)``: one warp and one JtJ reduction over the E edges.

    :return: ``(JtWJ [E,6,6], JtR [E,6], cost [E])``
    """
    f0, f1 = frames.feats[edges_i], frames.feats[edges_j]
    s0, s1 = frames.sigmas[edges_i], frames.sigmas[edges_j]
    d0, d1 = frames.invD[edges_i], frames.invD[edges_j]
    K = frames.K[edges_i]
    E, _, H, W_ = f0.shape
    px, py = W.generate_xy_grid(E, H, W_, K)
    pre = precompute_uic(d0, f0, s0, px, py, K)
    out, _, _ = compute_inverse_residuals(
        (R_rel, t_rel), d0, f0, s0, px, py, K, build_inverse_warp_operand(d1, f1, s1),
        remove_tru_sigma=remove_tru_sigma, plain=plain)
    JtWJ, JtR = jtj_jtr(uic_factors(pre, out.res, out.sigma, s0), out.weighted_res,
                        plain=plain)
    return JtWJ, JtR[..., 0], torch.sum(out.weighted_res ** 2, dim=(1, 2, 3))


def _assemble(R_rel, t_rel, edges_i, edges_j, JtWJ, JtR, n_poses):
    """Chain the per-edge systems into the global ``[6N,6N]`` H and
    ``[6N]`` b.

    :param R_rel, t_rel: the relative poses the edges were linearized at
    """
    G_j = -adjoint_se3(*inverse(R_rel, t_rel))  # [E,6,6]; G_i = I
    H_ij = JtWJ @ G_j
    H_jj = G_j.transpose(-1, -2) @ JtWJ @ G_j
    b_j = torch.einsum("eji,ej->ei", G_j, JtR)
    return scatter_blocks(edges_i, edges_j, n_poses, JtWJ, H_ij, H_jj, JtR, b_j)


def refine_dense_window(
    frames: WindowFrames,
    R: torch.Tensor,
    t: torch.Tensor,
    edges_i: torch.Tensor,
    edges_j: torch.Tensor,
    edge_weights: Optional[torch.Tensor] = None,
    iterations: int = 5,
    damping: float = 1e-4,
    anchor_weight: float = 1e6,
    remove_tru_sigma: bool = False,
    mesh=None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jointly refine the window's poses against the dense feature-metric
    residuals of its edges.

    :param R, t: [N,3,3], [N,3] initial camera-to-world poses
    :param edges_i/edges_j: [E] edge endpoints (template=i, live=j)
    :param edge_weights: optional [E] weights; 0 pads the edge list without
        counting a constraint twice
    :param mesh: a ``parallel.mesh.Mesh`` whose ranks split the edges (each
        rank passes them all; their count must divide by the world size)
    :param plain: the kernels' plain versions on any device
    :return: ``(R [N,3,3], t [N,3], costs [iterations])``: each cost is the
        weighted sum of the squared residuals before that iteration's update
    """
    n_poses = R.shape[0]
    n6 = n_poses * 6
    if edge_weights is None:
        edge_weights = torch.ones(edges_i.shape, dtype=R.dtype, device=R.device)
    sharded = mesh is not None and mesh.world > 1
    if sharded:
        E = edges_i.shape[0]
        if E % mesh.world:
            raise ValueError(f"pad the edges to a multiple of {mesh.world} (E={E})")
        rows = slice(mesh.rank * (E // mesh.world), (mesh.rank + 1) * (E // mesh.world))
        edges_i, edges_j, edge_weights = edges_i[rows], edges_j[rows], edge_weights[rows]
    eye = torch.eye(n6, dtype=R.dtype, device=R.device)
    anchor = torch.zeros(n6, dtype=R.dtype, device=R.device)
    anchor[:6] = anchor_weight
    costs = []
    for _ in range(iterations):
        R_rel, t_rel = compose(*inverse(R[edges_j], t[edges_j]), R[edges_i], t[edges_i])
        with M.active(None):  # the shard's own sigma min/max, as in shard_map
            JtWJ, JtR, cost = edge_linearization(frames, edges_i, edges_j, R_rel, t_rel,
                                                 remove_tru_sigma, plain=plain)
        JtWJ = JtWJ * edge_weights[:, None, None]
        JtR = JtR * edge_weights[:, None]
        H, b = _assemble(R_rel, t_rel, edges_i, edges_j, JtWJ, JtR, n_poses)
        cost = torch.sum(cost * edge_weights)
        if sharded:
            for x in (H, b, cost):
                dist.all_reduce(x, group=mesh.group)
        trace = torch.trace(H) / n6
        Hd = H + torch.diag(anchor) + (damping * trace + 1e-9) * eye
        xi = torch.linalg.solve_ex(Hd, b[:, None])[0].reshape(n_poses, 6)
        R, t = compose(R, t, *exp_se3(-xi))
        costs.append(cost)
    return R, t, torch.stack(costs)
