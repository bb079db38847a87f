"""PyTorch port vs the JAX package: the kernels of the feature preset's
training path, through their plain versions on the CPU: K2
``gather_twohot_grads`` and K3 ``splat_twohot``, the warp's autograd
Function ``BilinearGather``, and K6's closed-form backward ``FusedJtJ``.

Inputs from numpy seeds.  Tolerances (f32):

- K2 plain version (``gather_twohot_grads_ref``) vs the XLA
  ``_corner_grads_oneshot``: atol 1e-6 (same formulas, last-bit rounding);
  vs the Pallas ``gather_twohot_grads`` in interpret mode: atol 2e-4 of the
  largest operand entry (that kernel is bf16x3 "high" precision), the bound
  of ``tests/test_pallas.py``;
- K3 plain version (``splat_twohot_ref``) vs the XLA ``_splat_twohot``:
  atol 1e-5 of the largest cotangent times the samples per cell (summation
  order); vs the Pallas ``splat_twohot`` in interpret mode: 2e-4 of the same
  scale ("high" precision), as ``tests/test_pallas.py`` bounds it;
- ``BilinearGather`` value and gradients vs ``jax.grad`` of
  ``warp._bilinear_gather_cl``: atol 1e-5 of the largest entry of each
  (the operand cotangent sums samples in another order); through the Pallas
  interpreter 4e-4 of it, the bound of ``tests/test_pallas.py``;
- ``FusedJtJ``'s closed-form backward vs autograd through ``jtj_jtr_ref``:
  rtol 1e-5, atol 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.ops.kernels import (
    FusedJtJ,
    gather_twohot_grads,
    gather_twohot_grads_ref,
    jtj_jtr_ref,
    splat_twohot,
    splat_twohot_ref,
)
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.ops.pallas.gather import gather_twohot_grads as jax_grads
from deep_prob_feature_track_tpu.ops.pallas.gather import splat_twohot as jax_splat

torch.set_num_threads(2)

B = 2
GATHER_SHAPES = [(2, 24, 32, 10, 24 * 32), (1, 16, 20, 1, 77)]


def _coords(rng, B, H, W, N):
    u = rng.uniform(-3, W + 2, (B, N)).astype(np.float32)
    v = rng.uniform(-3, H + 2, (B, N)).astype(np.float32)
    # exact borders and cell edges: clamped starts get fractional weight 1
    u[:, :6] = [0.0, W - 1.0, W - 2.0, 3.0, W - 1.0, -0.0]
    v[:, :6] = [H - 1.0, 0.0, 5.0, H - 2.0, H - 1.0, 0.0]
    return u, v


def _starts(shape, u, v):
    """JAX corner starts and weights, and the same as torch tensors."""
    starts, du, dv, _, _ = jw._corner_weights(shape, jnp.asarray(u), jnp.asarray(v))
    port = tuple(torch.from_numpy(np.array(a)) for a in (
        starts[..., 0], dv[:, 0], starts[..., 1], du[:, 0]))
    return (starts, du, dv), port


# ----------------------------------------------------------- (a) K2 and K3


@pytest.mark.parametrize("B,H,W,C,N", GATHER_SHAPES)
def test_gather_grads_ref_matches_xla_and_pallas(rng, B, H, W, C, N):
    operand = rng.randn(B, H, W, C).astype(np.float32)
    u, v = _coords(rng, B, H, W, N)
    (starts, du, dv), args = _starts(operand.shape, u, v)
    got = gather_twohot_grads_ref(torch.from_numpy(operand), *args)
    assert all(g.shape == (B, C, N) for g in got)
    xla = jw._corner_grads_oneshot(jnp.asarray(operand), starts, du, dv)
    for g, r in zip(got, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    pallas = jax_grads(jnp.asarray(operand.reshape(B, H, W * C)), starts[..., 0], dv[:, 0, :],
                       starts[..., 1], du[:, 0, :], H=H, W=W, C=C, interpret=True)
    for g, r in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4 * np.abs(operand).max())
    # the dispatching entry takes the plain version for CPU tensors, and its
    # blend is the eval gather's bit for bit
    for a, b in zip(gather_twohot_grads(torch.from_numpy(operand), *args), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    eval_out = tw.gather_twohot_ref(torch.from_numpy(operand), *args)
    torch.testing.assert_close(got[0], eval_out, rtol=0, atol=0)


@pytest.mark.parametrize("B,H,W,C,N", GATHER_SHAPES)
def test_splat_ref_matches_xla_and_pallas(rng, B, H, W, C, N):
    u, v = _coords(rng, B, H, W, N)
    g = rng.randn(B, C, N).astype(np.float32)
    (starts, du, dv), args = _starts((B, H, W, C), u, v)
    got = splat_twohot_ref(torch.from_numpy(g), *args, H, W)
    assert got.shape == (B, H, W, C)
    scale = np.abs(g).max() * max(1.0, N / (H * W)) * 4
    xla = jw._splat_twohot((B, H, W, C), starts, du, dv, jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=1e-5 * scale, rtol=0)
    pallas = jax_splat(jnp.asarray(np.swapaxes(g, 1, 2)), starts[..., 0], dv[:, 0, :],
                       starts[..., 1], du[:, 0, :], H=H, W=W, C=C, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-4 * scale, rtol=0)
    torch.testing.assert_close(splat_twohot(torch.from_numpy(g), *args, H, W), got,
                               rtol=0, atol=0)


# ------------------------------------------------- (b) the autograd Function


@pytest.mark.parametrize("interpret", [False, True])
def test_bilinear_gather_function_matches_jax_grad(rng, monkeypatch, interpret):
    Bq, Hq, Wq, C, N = 2, 24, 32, 10, 300
    operand = rng.randn(Bq, Hq, Wq, C).astype(np.float32)
    u, v = _coords(rng, Bq, Hq, Wq, N)
    g = rng.randn(Bq, C, N).astype(np.float32)
    if interpret:
        monkeypatch.setenv("DPFT_PALLAS_GATHER", "1")
        monkeypatch.setenv("DPFT_PALLAS_INTERPRET", "1")

    def loss(op, uu, vv):
        return jnp.sum(jw._bilinear_gather_cl(op, uu, vv) * g)

    ref_val = jw._bilinear_gather_cl(jnp.asarray(operand), jnp.asarray(u), jnp.asarray(v))
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (operand, u, v)))

    op_t, u_t, v_t = (torch.from_numpy(a).requires_grad_() for a in (operand, u, v))
    val = tw.BilinearGather.apply(op_t, u_t, v_t, False)
    grads = torch.autograd.grad((val * torch.from_numpy(g)).sum(), (op_t, u_t, v_t))
    rel = 4e-4 if interpret else 1e-5
    for got, ref in zip((val.detach(), *grads), (ref_val, *ref_grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=rel * np.abs(ref).max(), rtol=0)
    # out-of-range coordinates get no gradient; the closed border does
    gu = grads[1].numpy()
    outside = (u < 0) | (u > Wq - 1)
    assert (gu[outside] == 0).all() and (gu[:, 1] != 0).all()


def test_warp_operand_routes_by_autograd(rng):
    operand = torch.from_numpy(rng.randn(B, 16, 20, 3).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-1, 20, (B, 1, 4, 5)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 16, (B, 1, 4, 5)).astype(np.float32))
    plain = tw.warp_operand(operand, [1, 2], u, v)
    op = operand.clone().requires_grad_()
    recorded = tw.warp_operand(op, [1, 2], u, v)
    assert recorded[0].grad_fn is not None and plain[0].grad_fn is None
    for a, b in zip(recorded, plain):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    with torch.no_grad():
        assert tw.warp_operand(op, [1, 2], u, v)[0].grad_fn is None


# -------------------------------------------------------- (c) K6 backward


@pytest.mark.parametrize("uv_grad", [False, True])
def test_fused_jtj_backward_matches_autograd(rng, uv_grad):
    hw, C = 300, 8
    arrays = [rng.randn(*s).astype(np.float32)
              for s in ((B, C, hw), (B, C, hw), (B, C, hw), (B, hw, 6), (B, hw, 6))]
    G = torch.from_numpy(rng.randn(B, 6, 6).astype(np.float32))
    g_r = torch.from_numpy(rng.randn(B, 6, 1).astype(np.float32))

    def grads(fn):
        ins = [torch.from_numpy(a).requires_grad_(i < 3 or uv_grad)
               for i, a in enumerate(arrays)]
        jtj, jtr = fn(*ins)
        wrt = [t for t in ins if t.requires_grad]
        return (jtj, jtr), torch.autograd.grad((jtj * G).sum() + (jtr * g_r).sum(), wrt)

    out, got = grads(lambda *a: FusedJtJ.apply(*a, -1.0, False))
    ref_out, ref = grads(lambda *a: jtj_jtr_ref(*a, sign=-1.0))
    assert len(got) == (5 if uv_grad else 3)
    for a, b in zip((*out, *got), (*ref_out, *ref)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
