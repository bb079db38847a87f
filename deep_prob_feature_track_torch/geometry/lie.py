"""Batched SO(3)/SE(3) operations.

Counterpart of ``deep_prob_feature_track_tpu/geometry/lie.py``: ``skew``,
the SO(3) exp and log maps, ``rotation_angle``, ``inverse``, ``compose``,
``between``, quaternions both ways, the 24 euler conventions both ways,
``pose_vec_to_Rt`` (``euler`` and ``quat``), the SE(3) exp and log maps
and adjoint, and the 4x4 homogeneous form.  Branch-free: small angles and
the gimbal lock take ``where`` selects, so every function is batched and
differentiable.  A pose is ``(R [B,3,3], t [B,3])``; twists are ordered
``[rot, trs]``.
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


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3) log map: ``theta / (2 sin theta) * vee(R - R')``,
    with the cosine clipped to ``[-1 + 1e-7, 1 - 1e-7]`` and the factor 1/2
    where it lies within 1e-8 of +-1."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    near_identity = cos_theta.abs() >= 1.0 - 1e-8
    magnitude = torch.where(near_identity, 0.5,
                            0.5 * theta / torch.sin(torch.where(near_identity, 1.0, theta)))
    return magnitude[..., None] * vee


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


def quat_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[x, y, z]`` with ``w = 1`` before normalization
    ``[...,3]`` -> rotation matrix ``[...,3,3]``."""
    q = torch.cat([torch.ones_like(quat[..., :1]), quat], dim=-1)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


# the 24 euler conventions as (first axis, parity, repetition, frame): 's'
# is the static (extrinsic) frame, 'r' the rotating (intrinsic) one
_EULER_AXES = {
    "sxyz": (0, 0, 0, 0), "sxyx": (0, 0, 1, 0), "sxzy": (0, 1, 0, 0),
    "sxzx": (0, 1, 1, 0), "syzx": (1, 0, 0, 0), "syzy": (1, 0, 1, 0),
    "syxz": (1, 1, 0, 0), "syxy": (1, 1, 1, 0), "szxy": (2, 0, 0, 0),
    "szxz": (2, 0, 1, 0), "szyx": (2, 1, 0, 0), "szyz": (2, 1, 1, 0),
    "rzyx": (0, 0, 0, 1), "rxyx": (0, 0, 1, 1), "ryzx": (0, 1, 0, 1),
    "rxzx": (0, 1, 1, 1), "rxzy": (1, 0, 0, 1), "ryzy": (1, 0, 1, 1),
    "rzxy": (1, 1, 0, 1), "ryxy": (1, 1, 1, 1), "ryxz": (2, 0, 0, 1),
    "rzxz": (2, 0, 1, 1), "rxyz": (2, 1, 0, 1), "rzyz": (2, 1, 1, 1),
}
_NEXT_AXIS = (1, 2, 0, 1)


def _euler_axes(axes: str):
    first, parity, repetition, frame = _EULER_AXES[axes]
    return first, _NEXT_AXIS[first + parity], _NEXT_AXIS[first - parity + 1], parity, \
        repetition, frame


def euler_to_matrix(ai, aj, ak, axes: str = "sxyz") -> torch.Tensor:
    """Batched euler angles -> rotation matrix, any of the 24 conventions;
    the default ``sxyz`` is ``R = Rz(ak) @ Ry(aj) @ Rx(ai)``."""
    i, j, k, parity, repetition, frame = _euler_axes(axes)
    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    m = [[None] * 3 for _ in range(3)]
    if repetition:
        m[i][i], m[i][j], m[i][k] = cj, sj * si, sj * ci
        m[j][i], m[j][j], m[j][k] = sj * sk, -cj * ss + cc, -cj * cs - sc
        m[k][i], m[k][j], m[k][k] = -sj * ck, cj * sc + cs, cj * cc - ss
    else:
        m[i][i], m[i][j], m[i][k] = cj * ck, sj * sc - cs, sj * cc + ss
        m[j][i], m[j][j], m[j][k] = cj * sk, sj * ss + cc, sj * cs - sc
        m[k][i], m[k][j], m[k][k] = -sj, cj * si, cj * ci
    return torch.stack([torch.stack(r, dim=-1) for r in m], dim=-2)


def matrix_to_euler(M: torch.Tensor, axes: str = "sxyz"):
    """Inverse of :func:`euler_to_matrix`: ``(ai, aj, ak)``.  At the gimbal
    lock (the sine or cosine of the middle angle within 1e-8 of 0) the
    third angle is 0 and the first takes the whole rotation."""
    i, j, k, parity, repetition, frame = _euler_axes(axes)
    if repetition:
        sy = torch.sqrt(M[..., i, j] ** 2 + M[..., i, k] ** 2)
        degenerate = sy <= 1e-8
        ax = torch.where(degenerate, torch.atan2(-M[..., j, k], M[..., j, j]),
                         torch.atan2(M[..., i, j], M[..., i, k]))
        ay = torch.atan2(sy, M[..., i, i])
        az = torch.where(degenerate, 0.0, torch.atan2(M[..., j, i], -M[..., k, i]))
    else:
        cy = torch.sqrt(M[..., i, i] ** 2 + M[..., j, i] ** 2)
        degenerate = cy <= 1e-8
        ax = torch.where(degenerate, torch.atan2(-M[..., j, k], M[..., j, j]),
                         torch.atan2(M[..., k, j], M[..., k, k]))
        ay = torch.atan2(-M[..., k, i], cy)
        az = torch.where(degenerate, 0.0, torch.atan2(M[..., j, i], M[..., i, i]))
    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return ax, ay, az


def pose_vec_to_Rt(vec: torch.Tensor, rotation_mode: str = "euler"):
    """6-DoF vector -> (R, t), the rotation as euler angles (``sxyz``) or a
    quaternion (``quat``).

    The rotation is built from ``vec[..., 3:]``, the translation slice, as
    in the original model whose checkpoints were trained that way.
    """
    trs = vec[..., 3:]
    rot = vec[..., 3:]
    if rotation_mode == "euler":
        return euler_to_matrix(rot[..., 0], rot[..., 1], rot[..., 2]), trs
    if rotation_mode == "quat":
        return quat_to_matrix(rot), trs
    raise ValueError(f"unknown rotation mode {rotation_mode!r}")


def _skew_terms(w: torch.Tensor):
    """``theta^2``, ``theta``, the small-angle select and ``skew(w)``, ``skew(w)^2``."""
    theta_sq = torch.sum(w * w, dim=-1)
    Wm = skew(w)
    return theta_sq, torch.sqrt(theta_sq + _EPS), theta_sq < 1e-8, Wm, Wm @ Wm


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian ``I + (1-cos)/t^2 W + (t-sin)/t^3 W^2``, with
    Taylor terms near theta = 0."""
    theta_sq, theta, small, Wm, W2 = _skew_terms(w)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta + _EPS))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wm.shape)
    return eye + b[..., None, None] * Wm + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian ``I - W/2 + (1 - (t/2) cot(t/2))/t^2 W^2``,
    with Taylor terms near theta = 0."""
    theta_sq, theta, small, Wm, W2 = _skew_terms(w)
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / (theta_sq + _EPS))
        * (1.0 - half * torch.cos(half) / torch.sin(torch.where(small, 1.0, half))))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wm.shape)
    return eye - 0.5 * Wm + cot_term[..., None, None] * W2


def exp_se3(xi: torch.Tensor):
    """se(3) -> SE(3): twist ``[rot, trs]`` -> ``(R, J_l(w) rho)``."""
    w = xi[..., :3]
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(w), xi[..., 3:])
    return exp_so3(w), t


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3): the twist ``[log R, J_l(log R)^-1 t]``."""
    w = log_so3(R)
    rho = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(w), t)
    return torch.cat([w, rho], dim=-1)


def adjoint_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint in ``[rot, trs]`` twist order, ``[[R, 0], [skew(t) R, R]]``."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([skew(t) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


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


def transform_to_matrix4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``(R, t)`` -> homogeneous ``[...,4,4]``."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom.expand(R.shape[:-2] + (1, 4))], dim=-2)


def matrix4_to_Rt(T: torch.Tensor):
    """Homogeneous ``[...,4,4]`` -> ``(R, t)``."""
    return T[..., :3, :3], T[..., :3, 3]
