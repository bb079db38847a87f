"""PyTorch port vs the JAX package: the training path of the feature preset.

B=2 at 32x40, inputs from numpy seeds.  The plain versions of K2, K3 and
K6's backward and the autograd Function of the warp are held in
``tests/test_torch_port_train_kernels.py``, one ``compute_loss`` against
the JAX package's in ``tests/test_torch_port_train_jax.py``.  Tolerances
(f32):

- ``bilinear_resize``, ``epe3d`` and ``compute_rt_epe_loss``: atol 1e-6,
  rtol 1e-5;
- the port's training gradient through ``BilinearGather`` and ``FusedJtJ``
  vs autograd through the plain forward ops, both in float64 (on
  uniform-noise images the float32 gradient is chaotic, even between the
  JAX package's own float32 and float64 runs): rtol 1e-6
  with atol 1e-6 of each leaf's largest entry;
- three optimizer steps against the optax chain on fixed gradients: atol
  1e-6.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_prob_feature_track_torch import losses as tl
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.image import bilinear_resize
from deep_prob_feature_track_torch.ops.kernels import FusedJtJ, jtj_jtr_ref
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu import losses as jlosses
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.ops import image as jimage
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

B, H, W = 2, 32, 40


# ----------------------------------------------------------------- losses


def _flow_inputs(rng):
    depth = rng.uniform(0.5, 3.0, (B, 1, H, W)).astype(np.float32)
    K = np.tile([[26.0, 26.0, 19.5, 15.5]], (B, 1)).astype(np.float32)
    R = np.array(jl.exp_so3(jnp.asarray((rng.randn(B, 5, 3) * 0.05).astype(np.float32))))
    t = (rng.randn(B, 5, 3) * 0.05).astype(np.float32)
    invalid = (depth == depth.min()) | (depth == depth.max()) | (rng.rand(B, 1, H, W) < 0.1)
    return depth, K, R, t, invalid


@pytest.mark.parametrize("size", [(16, 20), (60, 80), (10, 13)])
def test_bilinear_resize_matches_jax(rng, size):
    x = rng.rand(B, 2, H, W).astype(np.float32)
    got = bilinear_resize(torch.from_numpy(x), *size)
    ref = jimage.bilinear_resize(jnp.asarray(x), *size)
    assert got.shape == (B, 2, *size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


def test_epe3d_matches_jax(rng):
    est = rng.randn(B, 3, H, W).astype(np.float32)
    gt = rng.randn(B, 3, H, W).astype(np.float32)
    gt[0, 1, 3, 4] = np.nan
    invalid = (rng.rand(B, 1, H, W) < 0.2).astype(np.float32)
    invalid[1] = 1.0  # a sample with no valid pixel scores 0
    for inv in (None, invalid):
        got = tl.epe3d(torch.from_numpy(est), torch.from_numpy(gt),
                       None if inv is None else torch.from_numpy(inv))
        ref = jlosses.epe3d(jnp.asarray(est), jnp.asarray(gt),
                            None if inv is None else jnp.asarray(inv))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_compute_rt_epe_loss_matches_jax(rng, mode):
    depth, K, R, t, invalid = _flow_inputs(rng)
    if mode == "eval":
        R, t = R[:, 0], t[:, 0]
    R_gt = np.array(jl.exp_so3(jnp.asarray((rng.randn(B, 3) * 0.05).astype(np.float32))))
    t_gt = (rng.randn(B, 3) * 0.05).astype(np.float32)
    args = (R, t, R_gt, t_gt, depth, K, invalid)
    got = tl.compute_rt_epe_loss(*map(torch.from_numpy, args))
    ref = jlosses.compute_rt_epe_loss(*map(jnp.asarray, args))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)
    # the true flow is detached: only the estimate gets a gradient
    R_t, t_t = (torch.from_numpy(a).requires_grad_() for a in (R, t))
    Rg, tg = (torch.from_numpy(a).requires_grad_() for a in (R_gt, t_gt))
    tl.compute_rt_epe_loss(R_t, t_t, Rg, tg, *map(torch.from_numpy, args[4:])).sum().backward()
    assert R_t.grad is not None and t_t.grad is not None
    assert (Rg.grad is None) == (mode == "train")


# --------------------------------------------------- the backward in float64


def test_training_backward_matches_plain_autograd_in_float64(monkeypatch):
    """The whole training gradient through the custom autograd Functions
    equals autograd through the plain forward ops (gather, blend, einsums)."""
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in tt.synthetic_batch(B, 16, 20, seed=1, device="cpu").items()}
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=True).reset_parameters(2)
    state = copy.deepcopy(net.state_dict())

    def loss_and_grads():
        net.load_state_dict(state)
        net.double().train().zero_grad()
        loss = tt.compute_loss(net, tt.TrainConfig(), batch)
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    loss, grads = loss_and_grads()

    def gather_autograd(operand, u, v, plain):
        return tw.gather_twohot_ref(operand, *tw._corner_weights(operand.shape, u, v))

    monkeypatch.setattr(tw.BilinearGather, "apply", gather_autograd)
    monkeypatch.setattr(FusedJtJ, "apply", lambda *a: jtj_jtr_ref(*a[:5], sign=a[5]))
    ref_loss, ref = loss_and_grads()
    assert abs(loss - ref_loss) <= 1e-9 * abs(ref_loss)
    for key, r in ref.items():
        torch.testing.assert_close(grads[key], r, rtol=1e-6, atol=1e-6 * r.abs().max().item(),
                                   msg=key)


def test_flax_batchnorm_update_uses_biased_variance(rng):
    from deep_prob_feature_track_torch.models.layers import BatchNorm1d

    x = torch.from_numpy(rng.randn(2, 3, 5).astype(np.float32) * 2 + 1)
    bn = BatchNorm1d(3, eps=1e-5, momentum=0.1).train()
    y = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    ref = torch.nn.functional.batch_norm(x, None, None, training=True, eps=1e-5)
    torch.testing.assert_close(y, ref)


# -------------------------------------------------- optimizer and schedule


def test_optimizer_matches_optax_chain(rng):
    cfg = tt.TrainConfig(lr_decay_epochs=(1, 2))
    params = [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    # gradient norms below and above the clip of 5.0
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params]
             for s in (0.5, 10.0, 3.0)]
    tx = jt.make_optimizer(jt.TrainConfig(lr_decay_epochs=(1, 2)), steps_per_epoch=1)
    p_j = [jnp.asarray(p) for p in params]
    state = tx.init(p_j)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, p_j)
        p_j = optax.apply_updates(p_j, updates)

    p_t = [torch.from_numpy(p).requires_grad_() for p in params]
    optimizer = tt.make_optimizer(cfg, p_t)
    schedule = tt.make_lr_schedule(cfg, steps_per_epoch=1)
    for step, g in enumerate(grads):
        for p, x in zip(p_t, g):
            p.grad = torch.tensor(x)
        norm = tt.clip_gradients(p_t, cfg.grad_clip)
        tt.apply_update(optimizer, schedule(step))
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_lr_schedule_matches_optax():
    cfg = tt.TrainConfig(lr=4e-4, lr_decay_epochs=(2, 4, 4))
    ours = tt.make_lr_schedule(cfg, steps_per_epoch=10)
    ref = jt.make_lr_schedule(jt.TrainConfig(lr=4e-4, lr_decay_epochs=(2, 4, 4)), 10)
    for step in (0, 19, 20, 21, 39, 40, 45, 1000):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


# ------------------------------------------------------- the train step


def test_train_step_runs_and_refuses_a_bad_config():
    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature")), cfg, seed=1,
                                  device="cpu")
    assert state.net.training
    before = copy.deepcopy(state.net.state_dict())
    step = tt.make_train_step(cfg, steps_per_epoch=10)
    batch = tt.synthetic_batch(B, 16, 20, seed=5, device="cpu")
    state, metrics = step(state, batch)
    assert state.step == 1
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    moved = [k for k, v in state.net.state_dict().items() if not torch.equal(v, before[k])]
    assert "encoder.net0.0.0.weight" in moved and "pose_predictor.final_layer.1.bias" in moved
    with pytest.raises(ValueError, match="accum_steps"):
        tt.make_train_step(tt.TrainConfig(accum_steps=0), 10)
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        tt.make_train_step(tt.TrainConfig(accum_steps=3), 10)(state, batch)
    with pytest.raises(ValueError, match="uncer_prop"):
        tt.compute_loss(state.net, tt.TrainConfig(loss="URPE"), batch)
    with pytest.raises(ValueError, match="training mode"):
        tt.compute_loss(copy.deepcopy(state.net).eval(), cfg, batch)
