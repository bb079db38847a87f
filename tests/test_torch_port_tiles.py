"""PyTorch port vs the JAX package: the plain versions of K4
``gather_tiles`` and K5 ``gather_tiles_grads``, the warp through the tile
route, and the feature preset at 96x448, where level 0 takes the tile
kernels.  The route itself (``use_tiles``) is held in
``tests/test_torch_port_tiles_route.py``.

Inputs are made with numpy from seeds.  Tolerances (f32):

- the plain versions vs the Pallas ``gather_tiles`` / ``gather_tiles_grads``
  in interpret mode: atol 2e-4 (eval) and 4e-4 (grads) of the largest
  reference entry, the bounds of ``tests/test_gather_tiles.py`` (that kernel
  is bf16x3 "high" precision); vs the exact f32 ``_xla_fallback``: atol 1e-6;
- the warp through the route vs ``jax.grad`` of ``_bilinear_gather_cl``: on
  the tile kernels in interpret mode atol 6e-4 of the largest entry, as
  ``tests/test_gather_tiles.py`` bounds it; on the XLA path the values atol
  1e-6, the gradients 1e-5 of the largest entry (the operand cotangent sums
  samples in another order);
- the eval forward at 96x448: atol 1e-4 on R and t; the training loss there
  within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps.serve import example_batch
from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.from_flax import from_flax
from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops import kernels as tk
from deep_prob_feature_track_torch.ops.kernels import tiles
from deep_prob_feature_track_torch.training import train as tt
from deep_prob_feature_track_tpu.geometry import warp as jw
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker
from deep_prob_feature_track_tpu.ops.pallas import gather_tiles as jtiles
from deep_prob_feature_track_tpu.training import train as jt

torch.set_num_threads(2)

KEYS = ("color0", "color1", "depth0", "depth1", "calib")


# ------------------------------------------------ K4 / K5 plain versions


def make_coords(rng, B, H, W, Hs, Ws, disp=3.0):
    """Smooth small-displacement corner starts and weights, as
    ``tests/test_gather_tiles.py::make_coords`` makes them."""
    yy, xx = np.meshgrid(np.arange(Hs), np.arange(Ws), indexing="ij")
    u = xx[None] * (W / Ws) + disp * np.sin(yy[None] / 7.0 + rng.rand(B, 1, 1) * 3)
    v = yy[None] * (H / Hs) + disp * np.cos(xx[None] / 9.0 + rng.rand(B, 1, 1) * 3)
    uf = np.clip(u, 0.0, W - 1.0)
    vf = np.clip(v, 0.0, H - 1.0)
    u0 = np.minimum(np.floor(uf), W - 2).astype(np.int32)
    v0 = np.minimum(np.floor(vf), H - 2).astype(np.int32)
    return v0, (vf - v0).astype(np.float32), u0, (uf - u0).astype(np.float32)


def _tile_inputs(rng, H, W, C, teleport=False):
    B = 2
    operand = rng.randn(B, H, W, C).astype(np.float32)
    v0, dv, u0, du = make_coords(rng, B, H, W, H, W)
    if teleport:
        v0[0, 3, 4] = H - 2  # one sample across the image: its tile leaves the band
    return operand, (v0, dv, u0, du)


@pytest.mark.parametrize("grads", [False, True])
@pytest.mark.parametrize("H,W,C", [(72, 96, 5), (72, 96, 10)])
def test_tiles_ref_matches_jax_tiles(rng, H, W, C, grads):
    operand, maps = _tile_inputs(rng, H, W, C)
    assert jtiles.default_tile_config("grads" if grads else "eval", H, W, C, H, W) is not None
    op_t, maps_t = torch.from_numpy(operand), [torch.from_numpy(m) for m in maps]
    got = (tk.gather_tiles_grads_ref if grads else tk.gather_tiles_ref)(op_t, *maps_t)
    got = got if grads else (got,)
    assert all(g.shape == (2, C, H * W) for g in got)
    jax_fn = jtiles.gather_tiles_grads if grads else jtiles.gather_tiles
    pallas = jax_fn(jnp.asarray(operand), *map(jnp.asarray, maps), interpret=True, cfg=None)
    pallas = pallas if grads else (pallas,)
    exact = jtiles._xla_fallback(jnp.asarray(operand), *map(jnp.asarray, maps), grads)
    rel = 4e-4 if grads else 2e-4
    scale = float(np.abs(np.asarray(exact[0])).max())
    for g, p, e in zip(got, pallas, exact):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=rel * scale, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-6, rtol=0)
    # the dispatching entry takes the plain version for CPU tensors, and the
    # function is K1's (K2's) on the flattened maps, bit for bit
    entry = (tk.gather_tiles_grads if grads else tk.gather_tiles)(op_t, *maps_t)
    full = (tk.gather_twohot_grads_ref if grads else tk.gather_twohot_ref)(
        op_t, *[m.reshape(2, -1) for m in maps_t])
    for a, b, c in zip(entry if grads else (entry,), got, full if grads else (full,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(c, b, rtol=0, atol=0)


@pytest.mark.parametrize("grads", [False, True])
def test_tiles_ref_matches_jax_with_a_teleported_sample(rng, grads):
    """One sample leaves its tile's band: the JAX call falls back to its
    exact XLA gather, and the plain version matches both."""
    operand, maps = _tile_inputs(rng, 72, 96, 5, teleport=True)
    cfg = jtiles.default_tile_config("eval", 72, 96, 5, 72, 96)
    assert not bool(jtiles._prepare(jnp.asarray(operand), *map(jnp.asarray, maps), cfg)[3])
    got = (tk.gather_tiles_grads_ref if grads else tk.gather_tiles_ref)(
        torch.from_numpy(operand), *map(torch.from_numpy, maps))
    jax_fn = jtiles.gather_tiles_grads if grads else jtiles.gather_tiles
    ref = jax_fn(jnp.asarray(operand), *map(jnp.asarray, maps), interpret=True, cfg=None)
    exact = jtiles._xla_fallback(jnp.asarray(operand), *map(jnp.asarray, maps), grads)
    for g, r, e in zip(got if grads else (got,), ref if grads else (ref,), exact):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-6, rtol=0)


def test_tiles_args_are_checked():
    F = torch.zeros(2, 8, 9, 3)
    v0 = torch.zeros(2, 4, 5, dtype=torch.int32)
    f = torch.zeros(2, 4, 5)
    with pytest.raises(TypeError, match="int32"):
        tk.gather_tiles(F, f, f, f, f)
    with pytest.raises(ValueError, match=r"\[2, 4, 5\]"):
        tk.gather_tiles_grads(F, v0, f[:, :3], v0, f)
    with pytest.raises(ValueError, match="Hs,Ws"):
        tk.gather_tiles(F, v0.reshape(2, 20), f, v0, f)
    with pytest.raises(ValueError, match="2x2"):
        tk.gather_tiles(torch.zeros(2, 1, 9, 3), v0, f, v0, f)
    with pytest.raises(ValueError, match="CUDA"):
        tk.gather_tiles_cuda(F, v0, f, v0, f)


def test_staged_share_follows_the_coordinates(rng):
    """Smooth small motion (0.8-pixel sinusoids, whose boxes K4's window
    holds) stages every tile of K4 and K5; one teleported sample sends its
    own tile to the global path; uniform random coordinates send them all."""
    H, W, C = 72, 96, 10
    v0, _, u0, _ = make_coords(rng, 2, H, W, H, W, disp=0.8)
    v0, u0 = torch.from_numpy(v0), torch.from_numpy(u0)
    noise = torch.from_numpy(rng.randint(0, H - 1, v0.shape).astype(np.int32))
    for share, th in ((tiles.staged_share, tiles.tile_rows(C)),
                      (tiles.grads_staged_share, tiles.GRADS_TILE_H)):
        rows, cols = -(-H // th), -(-W // tiles.TILE_W)
        assert share(v0, u0, H, W, C) == 1.0
        moved = v0.clone()
        moved[0, 3, 4] = H - 2
        assert share(moved, u0, H, W, C) == pytest.approx(1.0 - 1.0 / (2 * rows * cols))
        assert share(noise, noise, H, W, C) == 0.0
        # a ragged sample grid (not a multiple of the tile) counts its edge tiles
        ragged = share(moved[:, :70, :90].contiguous(), u0[:, :70, :90].contiguous(), H, W, C)
        assert ragged == pytest.approx(1.0 - 1.0 / (2 * -(-70 // th) * -(-90 // tiles.TILE_W)))


# --------------------------------------------- the warp through the route


def _warp_inputs(rng, B=2, H=96, W=448, C=10):
    operand = rng.randn(B, H, W, C).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    u = np.repeat((xx + 2.5 * np.sin(yy / 9.0) + 0.3)[None, None], B, 0).astype(np.float32)
    v = np.repeat((yy + 2.5 * np.cos(xx / 7.0) + 0.2)[None, None], B, 0).astype(np.float32)
    g = rng.randn(B, C, H * W).astype(np.float32)
    return operand, u, v, g


@pytest.mark.parametrize("pallas", [False, True])
def test_warp_through_the_tile_route_matches_jax(rng, monkeypatch, pallas):
    operand, u, v, g = _warp_inputs(rng)
    B, H, W, C = operand.shape
    assert tiles.use_tiles("eval", H, W, C, H, W) and tiles.use_tiles("grads", H, W, C, H, W)
    if pallas:  # the JAX tile kernels in interpret mode
        monkeypatch.setenv("DPFT_PALLAS_TILES", "1")
        monkeypatch.setenv("DPFT_PALLAS_INTERPRET", "1")
        assert jw._tiles_enabled(operand.shape, (H, W), jnp.float32, "eval")
        assert jw._tiles_enabled(operand.shape, (H, W), jnp.float32, "grads")
    else:  # the exact XLA gather
        monkeypatch.setenv("DPFT_PALLAS_GATHER", "0")
        monkeypatch.setenv("DPFT_PALLAS_TILES", "0")

    def loss(op, uu, vv):
        return jnp.sum(jw._bilinear_gather_cl(op, uu, vv) * g)

    ref_val = jw._bilinear_gather_cl(*map(jnp.asarray, (operand, u, v)))
    ref_grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (operand, u, v)))

    calls = []
    for name in ("gather_tiles", "gather_tiles_grads"):
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    op_t = torch.from_numpy(operand)
    val = torch.cat(tw.warp_operand(op_t, [1, 8, 1], *map(torch.from_numpy, (u, v))), 1)
    op_t, u_t, v_t = (torch.from_numpy(a).requires_grad_() for a in (operand, u, v))
    val_ad = tw.BilinearGather.apply(op_t, u_t, v_t, False)
    grads = torch.autograd.grad((val_ad * torch.from_numpy(g)).sum(), (op_t, u_t, v_t))
    assert calls == ["gather_tiles", "gather_tiles_grads"]
    torch.testing.assert_close(val.reshape(B, C, -1), val_ad.detach(), rtol=0, atol=0)

    for i, (got, ref) in enumerate(zip((val_ad.detach(), *grads), (ref_val, *ref_grads))):
        ref = np.asarray(ref)
        if pallas:
            atol = 6e-4 * max(np.abs(ref).max(), 1.0)
        else:
            atol = 1e-6 if i == 0 else 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)


# --------------------------------------------- the slice at 96x448

B_SLICE, H_SLICE, W_SLICE = 2, 96, 448
# max |dR|, |dt| of the port's eval forward against the JAX forward, measured
# on these inputs on the CPU: 3.0e-8 / 4.9e-8 with the JAX tile and two-hot
# kernels in interpret mode (bf16x3 "high" precision), 2.4e-8 / 3.7e-8 on its
# XLA gather.  Bounded at 1e-5, well under the forward's 1e-4.  The training
# loss there: 7.2e-5 relative, inside 1e-4.
SLICE_ATOL = 1e-5


@pytest.fixture(scope="module")
def slice_models():
    """(JAX tracker, its PRNGKey(7) variables, the port tracker with them,
    the numpy batch): smooth scenes at 96x448, where level 0 takes K4/K5."""
    batch = {k: v.numpy() for k, v in tt.synthetic_batch(B_SLICE, H_SLICE, W_SLICE,
                                                          seed=3, device="cpu").items()}
    net = JaxTracker(cfg=jp.get_preset("feature"))
    # the weights do not depend on the image size: initialise at 32x40
    small = [jnp.asarray(batch[k][..., :32, :40]) for k in KEYS[:4]] + [jnp.asarray(
        batch["calib"])]
    v = jax.jit(lambda k, *a: net.init(k, *a, train=False))(jax.random.PRNGKey(7), *small)
    port = LeastSquareTracking(get_preset("feature"))
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, dict(v))), strict=True)
    return net, v, port, batch


@pytest.fixture(scope="module")
def slice_pose(slice_models):
    _, _, port, batch = slice_models
    with torch.inference_mode():
        R, t = port(*[torch.from_numpy(batch[k]) for k in KEYS])
    return R.numpy(), t.numpy()


@pytest.mark.parametrize("pallas", [False, True])
def test_forward_at_96x448_matches_jax(slice_models, slice_pose, monkeypatch, pallas):
    net, v, _, batch = slice_models
    if pallas:  # every gather through the JAX kernels: K4 at level 0, K1 above
        monkeypatch.setenv("DPFT_PALLAS_INTERPRET", "1")
    fwd = jax.jit(lambda v, *a: net.apply(v, *a, train=False))
    Rj, tj = fwd(v, *[jnp.asarray(batch[k]) for k in KEYS])
    np.testing.assert_allclose(slice_pose[0], np.asarray(Rj), atol=SLICE_ATOL)
    np.testing.assert_allclose(slice_pose[1], np.asarray(tj), atol=SLICE_ATOL)


def test_96x448_routes_level_0_through_the_tile_kernels(slice_models, monkeypatch):
    """Per eval forward: K4 3 times (level 0), K1 9 times; per training
    forward: K5 3 times, K2 9 times, as the JAX package routes them."""
    _, _, port, batch = slice_models
    calls = {}
    for name in ("gather_tiles", "gather_twohot", "gather_tiles_grads", "gather_twohot_grads"):
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _fn=fn, _n=name: calls.__setitem__(
            _n, calls.get(_n, 0) + 1) or _fn(*a))
    ins = [torch.from_numpy(batch[k]) for k in KEYS]
    with torch.inference_mode():
        port(*ins)
    assert calls == {"gather_tiles": 3, "gather_twohot": 9}
    calls.clear()
    net = LeastSquareTracking(get_preset("feature")).reset_parameters(1).train()
    net(*ins)
    assert calls == {"gather_tiles_grads": 3, "gather_twohot_grads": 9}


def test_train_loss_at_96x448_matches_jax(slice_models):
    net, v, port, batch = slice_models
    fn = jax.jit(lambda p, s, bb: jt.compute_loss(net, jt.TrainConfig(), p, s, bb)[0])
    ref = float(fn(v["params"], v["batch_stats"], {k: jnp.asarray(a) for k, a in batch.items()}))
    train = LeastSquareTracking(get_preset("feature"))
    train.load_state_dict(port.state_dict())
    got = tt.compute_loss(train.train(), tt.TrainConfig(),
                          {k: torch.from_numpy(a) for k, a in batch.items()}).item()
    assert np.isfinite(got) and abs(got - ref) <= 1e-4 * abs(ref), (got, ref)


# --------------------------------------------- example_batch intrinsics


def test_example_batch_intrinsics_follow_the_image_size():
    np.testing.assert_array_equal(example_batch(2, 120, 160, device="cpu")[4].numpy(),
                                  [[131.25, 131.25, 79.875, 59.875]] * 2)
    np.testing.assert_array_equal(example_batch(1, 480, 640, device="cpu")[4].numpy(),
                                  [[525.0, 525.0, 319.5, 239.5]])
    assert example_batch(1, 480, 640, device="cpu")[0].shape == (1, 3, 480, 640)
