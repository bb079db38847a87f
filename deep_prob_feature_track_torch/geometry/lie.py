"""Batched SO(3)/SE(3) helpers of the tracker's eval path.

Counterpart of ``deep_prob_feature_track_tpu/geometry/lie.py`` (``skew``,
``exp_so3``, ``rotation_angle``, ``inverse``, ``compose``, ``between``,
``euler_to_matrix``, ``pose_vec_to_Rt`` and ``matrix_to_quat``).
A pose is ``(R [B,3,3], t [B,3])``; twists are ordered ``[rot, trs]``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(w: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] skew-symmetric matrix."""
    o = torch.zeros_like(w[..., 0])
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [
            torch.stack([o, -w2, w1], dim=-1),
            torch.stack([w2, o, -w0], dim=-1),
            torch.stack([-w1, w0, o], dim=-1),
        ],
        dim=-2,
    )


def exp_so3(twist: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) (Rodrigues), with Taylor terms near theta = 0."""
    theta_sq = torch.sum(twist * twist, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS)
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS)
    )
    w = skew(twist)
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(w.shape)
    return eye + a[..., None, None] * w + b[..., None, None] * (w @ w)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Axis-angle magnitude of a batch of rotations; the cosine is clipped
    to ``[-1 + 1e-7, 1 - 1e-7]``, so the identity gives ``arccos(1 - 1e-7)``."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-7
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0 + eps, 1.0 - eps))


def inverse(R, t):
    """Pose inverse ``[R^T | -R^T t]``."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def compose(d_R, d_t, R0, t0):
    """Left-compose ``[dR@R0 | dR@t0 + dt]``."""
    R1 = d_R @ R0
    t1 = torch.einsum("...ij,...j->...i", d_R, t0) + d_t
    return R1, t1


def between(R0, t0, R1, t1):
    """Relative pose ``T1 o T0^{-1}``."""
    dR = R1 @ R0.transpose(-1, -2)
    return dR, t1 - torch.einsum("...ij,...j->...i", dR, t0)


def euler_to_matrix(ai, aj, ak, axes: str = "sxyz") -> torch.Tensor:
    """Batched euler angles -> rotation matrix, ``R = Rz(ak) @ Ry(aj) @ Rx(ai)``.

    Only the static-frame ``sxyz`` convention is ported: it is the one
    ``pose_vec_to_Rt`` uses.
    """
    if axes != "sxyz":
        raise NotImplementedError(f"euler convention {axes!r} is not ported")
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    rows = [
        torch.stack([cj * ck, sj * sc - cs, sj * cc + ss], dim=-1),
        torch.stack([cj * sk, sj * ss + cc, sj * cs - sc], dim=-1),
        torch.stack([-sj, cj * si, cj * ci], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def pose_vec_to_Rt(vec: torch.Tensor, rotation_mode: str = "euler"):
    """6-DoF vector -> (R, t).

    The rotation is built from ``vec[..., 3:]``, the translation slice, as
    in the original model whose checkpoints were trained that way.
    """
    if rotation_mode != "euler":
        raise NotImplementedError(f"rotation mode {rotation_mode!r} is not ported")
    trs = vec[..., 3:]
    rot = vec[..., 3:]
    return euler_to_matrix(rot[..., 0], rot[..., 1], rot[..., 2]), trs


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [...,3,3] -> unit quaternion [...,4] ``[qx, qy, qz,
    qw]`` (the TUM trajectory order).

    Shepperd's four candidate solutions, each from the square root of a
    different diagonal combination, chosen branch-free: the ``qw`` one
    where the trace is positive, else the one of the largest diagonal
    entry, in the JAX function's order (so the signs agree with it).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = 0.5 * safe_sqrt(1.0 + tr)
    c0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where((tr > 0)[..., None], c0, torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
