"""The training mode ``bf16_residuals``: the trained gathers keep their
derivative maps gx/gy in bfloat16, as the JAX package does under
``DPFT_BF16_RESIDUALS=1``.

- K2's and K5's plain twins (``gather_twohot_grads_ref``,
  ``gather_tiles_grads_ref``) and their dispatching entries on CPU tensors,
  with ``bf16=True``: ``out`` the float32 call's bit for bit, gx/gy the
  float32 maps ``.to(torch.bfloat16)`` bit for bit, at C=1, 3, 6, 10, 11
  and 28.
- ``BilinearGather`` within ``utils/remat.py::bf16_maps`` against the JAX
  warp's gradients under
  ``DPFT_BF16_RESIDUALS=1``, as ``tests/test_warp.py::
  test_bf16_residuals_gradient_parity`` holds the JAX mode: the operand
  gradient the float32 gather's bit for bit (K3 never reads the maps) and
  the JAX one's within 1e-5 of its largest entry (summation order,
  ``tests/test_torch_port_train.py``); the coordinate gradients within 4e-3
  of the largest entry of the float32 ones and of the JAX bfloat16 ones.
- Every trained gather of a ``feature_icp``, ``DeepIC`` and U_FC
  ``MultiScale2w`` step (the ICP warp and the learned nets' upsamples too)
  saves bfloat16 maps; an eval forward under autograd saves float32 maps,
  and the setting ends with the forward.

The step against the JAX package's ``DPFT_BF16_RESIDUALS=1`` step is in
``tests/test_torch_port_bf16_residuals_jax.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops import kernels as tk
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_torch.utils.remat import bf16_maps, keeps_bf16_maps
from deep_prob_feature_track_tpu.geometry import warp as jw

torch.set_num_threads(2)

CHANNELS = (1, 3, 6, 10, 11, 28)


def _starts(B, H, W, shape, seed):
    """Corner starts and weights of coordinates over and past an H x W
    plane, shaped ``shape`` ([B,N] or [B,Hs,Ws])."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(B, 1, *shape[1:], generator=g) * (W + 4) - 2
    v = torch.rand(B, 1, *shape[1:], generator=g) * (H + 4) - 2
    return [t.reshape(shape) for t in tw._corner_weights((B, H, W, 1), u, v)]


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("kernel", ["gather_twohot_grads", "gather_tiles_grads"])
def test_bf16_maps_are_the_float32_maps_rounded(kernel, C):
    B, H, W = 2, 17, 23
    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(C)) * 3
    shape = (B, 5, 9) if kernel == "gather_tiles_grads" else (B, 45)
    args = _starts(B, H, W, shape, seed=C + 1)
    for fn in (getattr(tk, f"{kernel}_ref"), getattr(tk, kernel)):
        out32, gx32, gy32 = fn(F, *args)
        out, gx, gy = fn(F, *args, True)
        assert out.dtype == torch.float32 and gx.dtype == gy.dtype == torch.bfloat16
        assert torch.equal(out, out32)
        for got, ref in ((gx, gx32), (gy, gy32)):
            assert torch.equal(got.view(torch.int16), ref.to(torch.bfloat16).view(torch.int16))


def test_bilinear_gather_bf16_matches_the_jax_bf16_warp(rng, monkeypatch):
    B, C, H, W = 2, 3, 9, 11
    F = rng.randn(B, C, H, W).astype(np.float32)
    u = rng.uniform(-1.0, W, (B, 1, 4, 5)).astype(np.float32)
    v = rng.uniform(-1.0, H, (B, 1, 4, 5)).astype(np.float32)
    t = rng.randn(B, C, 4, 5).astype(np.float32)

    def jax_grads():
        def loss(F_, u_, v_):
            return jnp.sum(jw.warp_features(F_, u_, v_) * t)

        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(F, u, v)]

    monkeypatch.setenv("DPFT_BF16_RESIDUALS", "1")
    ref = jax_grads()

    def port_grads(bf16):
        ins = [torch.from_numpy(a).requires_grad_() for a in (F, u, v)]
        with bf16_maps(bf16):
            out = tw.warp_features(*ins)
        return [g.numpy() for g in torch.autograd.grad((out * torch.from_numpy(t)).sum(), ins)]

    got, f32 = port_grads(True), port_grads(False)
    np.testing.assert_array_equal(got[0], f32[0])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5 * np.abs(ref[0]).max())
    for g, r, r32 in zip(got[1:], ref[1:], f32[1:]):
        np.testing.assert_allclose(g, r, rtol=0, atol=4e-3 * np.abs(r).max())
        np.testing.assert_allclose(g, r32, rtol=0, atol=4e-3 * np.abs(r32).max())
    assert any((g != r32).any() for g, r32 in zip(got[1:], f32[1:]))  # the maps were rounded


@pytest.mark.parametrize("preset,overrides,H,W", [
    ("feature_icp", (), 32, 40), ("DeepIC", (), 32, 40),
    ("feature", ("direction=forward", "mest_type=MultiScale2w", "train_init_pose=false"), 64, 80),
])
def test_every_trained_gather_saves_bf16_maps(monkeypatch, preset, overrides, H, W):
    saved = []
    grads = tw.gather_twohot_grads

    def recording(*a):
        out = grads(*a)
        saved.append(out[1].dtype)
        return out

    monkeypatch.setattr(tw, "gather_twohot_grads", recording)
    cfg = apply_overrides(get_preset(preset), list(overrides))
    net = LeastSquareTracking(cfg, bf16_residuals=True).reset_parameters(1).train()
    loss = tt.compute_loss(net, tt.TrainConfig(), tt.synthetic_batch(2, H, W, seed=3,
                                                                     device="cpu"))
    loss.backward()
    assert np.isfinite(loss.item()) and saved and set(saved) == {torch.bfloat16}
    assert not keeps_bf16_maps()
    saved.clear()
    batch = tt.synthetic_batch(2, H, W, seed=3, device="cpu")
    net.eval()(batch["color0"], batch["color1"], batch["depth0"], batch["depth1"],
               batch["calib"])
    assert saved and set(saved) == {torch.float32}
