"""PyTorch port vs the JAX package: the training path of the feature preset.

B=2 at 32x40, inputs from numpy seeds.  Tolerances (f32):

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
  rtol 1e-5, atol 1e-5 of the largest entry;
- ``bilinear_resize``, ``epe3d`` and ``compute_rt_epe_loss``: atol 1e-6,
  rtol 1e-5;
- one ``compute_loss`` with the flax ``PRNGKey(7)`` weights: the loss within
  1e-4 relative; each gradient leaf within atol 5e-3 of the leaf's largest
  JAX entry, the envelope of 12 chained Gauss-Newton solves
  (``tests/test_training.py::test_scan_remat_loop_gradient_parity``); the
  BatchNorm running statistics after the step within rtol 1e-5 (atol 1e-7
  for entries near zero).  The batch is ``synthetic_batch``'s smooth
  textured scene, seed 3, whose worst leaf is well inside the envelope;
  some other seeds flip one pixel of a discrete mask (occlusion, sigma
  min/max) between the two roundings and leave it.  On uniform-noise images
  the float32 gradient is chaotic beyond the envelope, even between the JAX
  package's own float32 and float64 runs, so the wiring of the backward is
  also held tightly in float64, below;
- the port's training gradient through ``BilinearGather`` and ``FusedJtJ``
  vs autograd through the plain forward ops, both in float64: rtol 1e-6
  with atol 1e-6 of each leaf's largest entry;
- three optimizer steps against the optax chain on fixed gradients: atol
  1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_prob_feature_track_torch import losses as tl
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.image import bilinear_resize
from deep_prob_feature_track_torch.ops.kernels import (
    FusedJtJ,
    gather_twohot_grads,
    gather_twohot_grads_ref,
    jtj_jtr_ref,
    splat_twohot,
    splat_twohot_ref,
)
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu import losses as jlosses
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.ops import image as jimage
from deep_prob_feature_track_tpu.ops.pallas.gather import gather_twohot_grads as jax_grads
from deep_prob_feature_track_tpu.ops.pallas.gather import splat_twohot as jax_splat
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

B, H, W = 2, 32, 40
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


# ------------------------------------------------------------- (d) losses


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


# ------------------------------------------------- (e) one compute_loss


@pytest.fixture(scope="module")
def loss_and_grads():
    """JAX and port loss, parameter gradients and BatchNorm statistics of one
    training batch, from the same ``PRNGKey(7)`` weights."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B, H, W, seed=3, device="cpu").items()}
    net = JaxTracker(cfg=jp.get_preset("feature"))
    ins = [jnp.asarray(batch[k]) for k in ("color0", "color1", "depth0", "depth1", "calib")]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *ins)
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb), has_aux=True))
    (loss_j, stats_j), grads_j = fn(v["params"], v["batch_stats"],
                                    {k: jnp.asarray(a) for k, a in batch.items()})

    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    port.train()
    loss_t = tt.compute_loss(port, tt.TrainConfig(), {k: torch.from_numpy(a)
                                                      for k, a in batch.items()})
    loss_t.backward()
    return {
        "loss": (loss_t.detach().item(), float(loss_j)),
        "grads": ({k: p.grad for k, p in port.named_parameters()},
                  from_flax({"params": jax.tree.map(np.asarray, grads_j)})),
        "stats": (port.state_dict(), from_flax({"batch_stats": jax.tree.map(np.asarray,
                                                                            stats_j)})),
        "grad_norm": float(optax.global_norm(grads_j)),
    }


def test_compute_loss_matches_jax(loss_and_grads):
    got, ref = loss_and_grads["loss"]
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


def test_loss_gradients_match_jax(loss_and_grads):
    got, ref = loss_and_grads["grads"]
    assert set(got) == set(ref) and len(ref) == 79
    for key, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=5e-3 * max(np.abs(r).max(), 1e-12), err_msg=key)
    norm = torch.sqrt(sum((g * g).sum() for g in got.values())).item()
    assert abs(norm - loss_and_grads["grad_norm"]) <= 5e-3 * loss_and_grads["grad_norm"]


def test_batchnorm_running_stats_match_flax(loss_and_grads):
    got, ref = loss_and_grads["stats"]
    stat_keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 46
    for key in stat_keys:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    # two encoder passes and the pose net: every BatchNorm counted its batches
    assert got["encoder.net0.0.1.num_batches_tracked"].item() == 2
    assert got["pose_predictor.net.0.1.num_batches_tracked"].item() == 1


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


# ---------------------------------------------- (f) optimizer and schedule


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
