"""Factored JtWJ / JtR reduction: CUDA kernel K6 and its plain version.

Replaces ``deep_prob_feature_track_tpu/ops/pallas/jtj.py::fused_jtj_jtr``
(``_kernel`` :26, entry :63).  The contract is the same:

    alpha, beta, res [B,C,HW] f32, u, v [B,HW,6] f32, sign
        ->  JtJ [B,6,6], JtR [B,6,1]

``fused_jtj_jtr`` dispatches on the tensors' device alone: CUDA tensors
launch the kernel (``csrc/fused_jtj_jtr.cu``: one launch, one thread-block
cluster per image whose rank 0 sums its peers' partial sums in rank order),
CPU tensors take ``jtj_jtr_ref``.  ``FusedJtJ`` makes the reduction differentiable: its
forward is ``fused_jtj_jtr`` and its backward the closed-form VJP in tensor
ops (the JAX package has no backward kernel here: XLA differentiates the
einsums of ``solvers/jacobians.py:97-120``).
"""

from __future__ import annotations

import torch

from . import loader

_launch = loader.launcher("fused_jtj_jtr", "fused_jtj_jtr_launch", "7P3ifP")
_F32 = torch.float32


def jtj_jtr_ref(alpha, beta, res, u, v, sign: float = -1.0):
    """Plain PyTorch version: the einsum math of the JAX ``jtj_jtr``."""
    A = torch.einsum("bcp,bcp->bp", alpha, alpha)
    Bx = torch.einsum("bcp,bcp->bp", alpha, beta)
    Cc = torch.einsum("bcp,bcp->bp", beta, beta)
    ar = torch.einsum("bcp,bcp->bp", alpha, res)
    br = torch.einsum("bcp,bcp->bp", beta, res)
    left1 = u * A[..., None] + v * Bx[..., None]
    left2 = u * Bx[..., None] + v * Cc[..., None]
    JtJ = torch.einsum("bpi,bpj->bij", left1, u) + torch.einsum("bpi,bpj->bij", left2, v)
    JtR = torch.einsum("bpi,bp->bi", u, ar) + torch.einsum("bpi,bp->bi", v, br)
    return JtJ, (sign * JtR)[..., None]


def _check(alpha, beta, res, u, v):
    if alpha.ndim != 3:
        raise ValueError(f"alpha must be [B,C,HW], got {tuple(alpha.shape)}")
    B, _, HW = alpha.shape
    for name, t, shape in (("alpha", alpha, alpha.shape), ("beta", beta, alpha.shape),
                           ("res", res, alpha.shape), ("u", u, (B, HW, 6)),
                           ("v", v, (B, HW, 6))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_jtj_jtr_cuda(alpha, beta, res, u, v, sign: float = -1.0):
    """Launch the CUDA kernel; every tensor must lie on the same card."""
    s, su, d = alpha.shape, u.shape, alpha.get_device()
    if not (alpha.is_cuda and len(s) == 3 and beta.shape == s and res.shape == s
            and len(su) == 3 and su[0] == s[0] and su[1] == s[2] and su[2] == 6
            and v.shape == su
            and alpha.dtype is _F32 and beta.dtype is _F32 and res.dtype is _F32
            and u.dtype is _F32 and v.dtype is _F32
            and alpha.is_contiguous() and beta.is_contiguous() and res.is_contiguous()
            and u.is_contiguous() and v.is_contiguous()
            and beta.get_device() == d and res.get_device() == d
            and u.get_device() == d and v.get_device() == d):
        _check(alpha, beta, res, u, v)
        raise ValueError("fused_jtj_jtr_cuda needs CUDA tensors on one device")
    B, C, HW = s
    jtj = alpha.new_empty((B, 6, 6))
    jtr = alpha.new_empty((B, 6, 1))
    _launch(alpha.data_ptr(), beta.data_ptr(), res.data_ptr(), u.data_ptr(), v.data_ptr(),
            jtj.data_ptr(), jtr.data_ptr(), B, C, HW, float(sign), loader.raw_stream(d))
    return jtj, jtr


def fused_jtj_jtr(alpha, beta, res, u, v, sign: float = -1.0):
    """K6 on CUDA tensors, its plain version on CPU tensors."""
    if alpha.is_cuda:
        return fused_jtj_jtr_cuda(alpha, beta, res, u, v, sign)
    _check(alpha, beta, res, u, v)
    return jtj_jtr_ref(alpha, beta, res, u, v, sign)


class FusedJtJ(torch.autograd.Function):
    """``(JtJ, JtR)`` of :func:`fused_jtj_jtr` with its VJP.

    With per-pixel ``A = sum_c alpha^2``, ``Bx = sum_c alpha beta``,
    ``Cc = sum_c beta^2``, ``ar = sum_c alpha r`` and ``br = sum_c beta r``,
    ``JtJ = sum_p A uu' + Bx (vu' + uv') + Cc vv'`` and
    ``JtR = sign sum_p (ar u + br v)``.  For cotangents ``G`` [B,6,6] and
    ``g`` [B,6,1]:

        dA = u'Gu, dBx = u'Gv + v'Gu, dCc = v'Gv, dar = sign u'g, dbr = sign v'g
        dalpha = 2 alpha dA + beta dBx + r dar
        dbeta  = alpha dBx + 2 beta dCc + r dbr
        dr     = alpha dar + beta dbr
        du = A (G+G')u + Bx (G+G')v + sign ar g,  dv likewise.

    ``plain=True`` runs the plain version in the forward on any device.
    """

    @staticmethod
    def forward(ctx, alpha, beta, res, u, v, sign: float, plain: bool):
        fn = jtj_jtr_ref if plain else fused_jtj_jtr
        jtj, jtr = fn(alpha, beta, res, u, v, sign)
        ctx.save_for_backward(alpha, beta, res, u, v)
        ctx.sign = sign
        return jtj, jtr

    @staticmethod
    def backward(ctx, G, g_r):
        alpha, beta, res, u, v = ctx.saved_tensors
        sign = ctx.sign
        uG = u @ G  # [B,HW,6]: row p is u_p' G
        vG = v @ G
        dA = (uG * u).sum(-1)[:, None]  # [B,1,HW]
        dBx = ((uG * v).sum(-1) + (vG * u).sum(-1))[:, None]
        dCc = (vG * v).sum(-1)[:, None]
        dar = sign * (u @ g_r)[:, None, :, 0]
        dbr = sign * (v @ g_r)[:, None, :, 0]
        d_alpha = 2 * alpha * dA + beta * dBx + res * dar
        d_beta = alpha * dBx + 2 * beta * dCc + res * dbr
        d_res = alpha * dar + beta * dbr
        d_u = d_v = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            Gs = G + G.transpose(1, 2)
            A = (alpha * alpha).sum(1)[..., None]  # [B,HW,1]
            Bx = (alpha * beta).sum(1)[..., None]
            Cc = (beta * beta).sum(1)[..., None]
            ar = (alpha * res).sum(1)[..., None]
            br = (beta * res).sum(1)[..., None]
            uGs, vGs = u @ Gs, v @ Gs
            g_row = sign * g_r.transpose(1, 2)  # [B,1,6]
            d_u = A * uGs + Bx * vGs + ar * g_row
            d_v = Bx * uGs + Cc * vGs + br * g_row
        return d_alpha, d_beta, d_res, d_u, d_v, None, None

