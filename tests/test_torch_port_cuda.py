"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA GPU.  This file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances: K1 (gather) must match its plain version bit for bit; K2's
``out`` too, and its gx/gy within 1e-6 of the largest entry; K4 and K5 (the
tile-staged gathers) the same as K1 and K2, whichever path each tile takes;
K3 (splat)
adds with float atomics, within 1e-5 of the largest entry; K6 (JtJ) sums in
another order than the plain version, rtol 1e-5 with atol 1e-5 of the
largest entry; the forward atol 1e-4 on R and t; one training step through
the kernels vs through the plain versions: the loss within 1e-5 relative,
each gradient leaf within 5e-3 of its largest entry (the envelope of 12
chained Gauss-Newton solves, ``tests/test_torch_port_train.py``).
"""

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.ops import kernels as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,W,C", [(8, 120, 160, 10), (8, 15, 20, 10), (1, 16, 20, 1),
                                     (3, 7, 9, 17)])
def test_gather_kernel_matches_plain_bitwise(cuda, B, H, W, C):
    g = torch.Generator().manual_seed(0)
    F = torch.randn(B, H, W, C, generator=g)
    u = torch.rand(B, 1, H, W, generator=g) * (W + 6) - 3
    v = torch.rand(B, 1, H, W, generator=g) * (H + 6) - 3
    u[:, 0, 0, :4] = torch.tensor([0.0, W - 1.0, W - 2.0, 3.0])
    v[:, 0, 0, :4] = torch.tensor([H - 1.0, 0.0, 5.0, H - 2.0])
    args = tw._corner_weights(F.shape, u.to(cuda), v.to(cuda))
    F = F.to(cuda)
    n0 = tk.LAUNCHES["gather_twohot"]
    out = tk.gather_twohot(F, args[0], args[1], args[2], args[3])
    assert tk.LAUNCHES["gather_twohot"] == n0 + 1
    ref = tk.gather_twohot_ref(F, *args)
    torch.cuda.synchronize()
    assert out.shape == (B, C, H * W)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _sample_inputs(cuda, B, H, W, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    F = torch.randn(B, H, W, C, generator=g)
    u = torch.rand(B, 1, H, W, generator=g) * (W + 6) - 3
    v = torch.rand(B, 1, H, W, generator=g) * (H + 6) - 3
    u[:, 0, 0, :4] = torch.tensor([0.0, W - 1.0, W - 2.0, 3.0])
    v[:, 0, 0, :4] = torch.tensor([H - 1.0, 0.0, 5.0, H - 2.0])
    return F.to(cuda), tw._corner_weights(F.shape, u.to(cuda), v.to(cuda))


@pytest.mark.parametrize("B,H,W,C", [(64, 120, 160, 10), (64, 15, 20, 10), (1, 16, 20, 1),
                                     (3, 7, 9, 17)])
def test_gather_grads_kernel_matches_plain(cuda, B, H, W, C):
    F, args = _sample_inputs(cuda, B, H, W, C)
    n0 = tk.LAUNCHES["gather_twohot_grads"]
    out, gx, gy = tk.gather_twohot_grads(F, *args)
    assert tk.LAUNCHES["gather_twohot_grads"] == n0 + 1
    ref = tk.gather_twohot_grads_ref(F, *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(out, tk.gather_twohot_cuda(F, *args), rtol=0, atol=0)
    for got, r in zip((gx, gy), ref[1:]):
        torch.testing.assert_close(got, r, rtol=0, atol=1e-6 * r.abs().max().item())


@pytest.mark.parametrize("B,H,W,C", [(64, 120, 160, 10), (64, 15, 20, 10), (1, 16, 20, 1),
                                     (3, 7, 9, 17)])
def test_splat_kernel_matches_plain(cuda, B, H, W, C):
    _, args = _sample_inputs(cuda, B, H, W, C, seed=1)
    g = torch.randn(B, C, H * W, generator=torch.Generator().manual_seed(2)).to(cuda)
    n0 = tk.LAUNCHES["splat_twohot"]
    d_op = tk.splat_twohot(g, *args, H, W)
    assert tk.LAUNCHES["splat_twohot"] == n0 + 1
    ref = tk.splat_twohot_ref(g, *args, H, W)
    torch.cuda.synchronize()
    assert d_op.shape == (B, H, W, C)
    torch.testing.assert_close(d_op, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("B,C,HW", [(8, 8, 19200), (8, 8, 300), (2, 3, 2049), (1, 8, 1)])
def test_jtj_kernel_matches_plain(cuda, B, C, HW):
    g = torch.Generator().manual_seed(1)
    args = [torch.randn(*s, generator=g).to(cuda)
            for s in ((B, C, HW), (B, C, HW), (B, C, HW), (B, HW, 6), (B, HW, 6))]
    n0 = tk.LAUNCHES["fused_jtj_jtr"]
    jtj, jtr = tk.fused_jtj_jtr(*args, sign=-1.0)
    assert tk.LAUNCHES["fused_jtj_jtr"] == n0 + 1
    jtj_r, jtr_r = tk.jtj_jtr_ref(*args, sign=-1.0)
    for got, ref in ((jtj, jtj_r), (jtr, jtr_r)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
    torch.testing.assert_close(jtj, jtj.transpose(1, 2), rtol=0, atol=0)
    again = tk.fused_jtj_jtr(*args, sign=-1.0)
    torch.testing.assert_close(again[0], jtj, rtol=0, atol=0)  # no atomics: same every run


def test_forward_kernels_match_plain_on_card(cuda):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    batch = example_batch(2, 60, 80, seed=3, device=cuda)
    kern = build_tracker("feature", device=cuda)
    plain = build_tracker("feature", device=cuda, plain_kernels=True)
    serve = {"gather_twohot": 12, "gather_twohot_grads": 0, "splat_twohot": 0,
             "fused_jtj_jtr": 12, "gather_tiles": 0, "gather_tiles_grads": 0}
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch)
        assert tk.LAUNCHES == serve
        Rp, tp = plain(*batch)
    assert tk.LAUNCHES == serve
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-4)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-4)
    eye = torch.eye(3, device=cuda).expand_as(R)
    assert (R.transpose(1, 2) @ R - eye).abs().max() < 1e-4
    assert np.isfinite(t.cpu().numpy()).all()


def test_train_step_kernels_match_plain_on_card(cuda):
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    batch = tt.synthetic_batch(4, 60, 80, seed=3, device=cuda)
    results = []
    for plain in (False, True):
        net = LeastSquareTracking(get_preset("feature"), plain_kernels=plain)
        state = tt.create_train_state(net, tt.TrainConfig(), seed=1, device=cuda)
        tk.reset_launches()
        loss = tt.compute_loss(state.net, tt.TrainConfig(), batch)
        loss.backward()
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        results.append((loss.item(), {k: p.grad for k, p in net.named_parameters()}))
    assert launches == {k: 0 for k in launches}  # the plain step launched nothing
    (loss, grads), (loss_p, grads_p) = results
    assert np.isfinite(loss) and abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for key, ref in grads_p.items():
        torch.testing.assert_close(grads[key], ref, rtol=0,
                                   atol=5e-3 * ref.abs().max().item(), msg=key)


def test_train_step_launches_each_kernel_12_times(cuda):
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature")), cfg, device=cuda)
    step = tt.make_train_step(cfg, steps_per_epoch=100)
    batch = tt.synthetic_batch(2, 60, 80, seed=4, device=cuda)
    tk.reset_launches()
    state, metrics = step(state, batch)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    assert tk.LAUNCHES == {"gather_twohot": 0, "gather_twohot_grads": 12, "splat_twohot": 12,
                           "fused_jtj_jtr": 12, "gather_tiles": 0, "gather_tiles_grads": 0}


def _tile_maps(cuda, B, H, W, Hs, Ws, coords, seed=0):
    """Corner starts and weights [B,Hs,Ws] on the card: ``smooth`` small
    motion (every tile stages its box), ``global`` uniform random coordinates
    (no tile does), ``mixed`` the smooth ones with a few samples teleported
    across the plane (one launch takes both paths)."""
    rng = np.random.RandomState(seed)
    if coords == "global":
        u = rng.uniform(-3, W + 2, (B, 1, Hs, Ws))
        v = rng.uniform(-3, H + 2, (B, 1, Hs, Ws))
    else:
        yy, xx = np.meshgrid(np.arange(Hs), np.arange(Ws), indexing="ij")
        u = xx * (W / Ws) + 0.8 * np.sin(yy / 9.0 + rng.rand(B, 1, 1, 1) * 3) + 0.3
        v = yy * (H / Hs) + 0.8 * np.cos(xx / 11.0 + rng.rand(B, 1, 1, 1) * 3) + 0.2
    if coords == "mixed":  # half the plane away
        for b, y, x in zip(rng.randint(0, B, 6), rng.randint(0, Hs, 6), rng.randint(0, Ws, 6)):
            u[b, 0, y, x] = (u[b, 0, y, x] + W / 2) % (W - 1)
            v[b, 0, y, x] = (v[b, 0, y, x] + H / 2) % (H - 1)
    u, v = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (u, v))
    return [t.reshape(B, Hs, Ws) for t in tw._corner_weights((B, H, W, 1), u, v)]


@pytest.mark.parametrize("coords", ["smooth", "global", "mixed"])
@pytest.mark.parametrize("B,H,W,C,Hs,Ws", [
    (4, 240, 320, 10, 240, 320),  # K5 at level 1 of the 640x480 step
    (2, 240, 320, 17, 240, 320),  # the un-slimmed operand
    (2, 96, 448, 10, 83, 301),    # a sample grid that is not a multiple of the tile
])
def test_tiles_kernels_match_plain(cuda, coords, B, H, W, C, Hs, Ws):
    from deep_prob_feature_track_torch.ops.kernels import tiles

    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(5)).to(cuda)
    maps = _tile_maps(cuda, B, H, W, Hs, Ws, coords)
    share = tiles.staged_share(maps[0], maps[2], H, W, C)
    assert {"smooth": share == 1.0, "global": share == 0.0,
            "mixed": 0.0 < share < 1.0}[coords], share
    n0 = dict(tk.LAUNCHES)
    out = tk.gather_tiles(F, *maps)
    got = tk.gather_tiles_grads(F, *maps)
    assert tk.LAUNCHES["gather_tiles"] == n0["gather_tiles"] + 1
    assert tk.LAUNCHES["gather_tiles_grads"] == n0["gather_tiles_grads"] + 1
    ref = tk.gather_tiles_grads_ref(F, *maps)
    torch.cuda.synchronize()
    assert out.shape == (B, C, Hs * Ws)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(out, tk.gather_tiles_ref(F, *maps), rtol=0, atol=0)
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6 * r.abs().max().item())


def test_96x448_forward_and_step_route_level_0_through_the_tile_kernels(cuda):
    """At 96x448 level 0 takes K4 (eval) and K5 (training), as the JAX
    package routes it; the kernels agree with their plain versions."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    batch = example_batch(2, 96, 448, seed=3, device=cuda)
    kern = build_tracker("feature", device=cuda)
    plain = build_tracker("feature", device=cuda, plain_kernels=True)
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch)
        assert tk.LAUNCHES == {"gather_twohot": 9, "gather_twohot_grads": 0, "splat_twohot": 0,
                               "fused_jtj_jtr": 12, "gather_tiles": 3, "gather_tiles_grads": 0}
        Rp, tp = plain(*batch)
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-4)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-4)

    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature")), cfg, device=cuda)
    step = tt.make_train_step(cfg, steps_per_epoch=100)
    tk.reset_launches()
    state, metrics = step(state, tt.synthetic_batch(2, 96, 448, seed=4, device=cuda))
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    assert tk.LAUNCHES == {"gather_twohot": 0, "gather_twohot_grads": 9, "splat_twohot": 12,
                           "fused_jtj_jtr": 12, "gather_tiles": 0, "gather_tiles_grads": 3}
