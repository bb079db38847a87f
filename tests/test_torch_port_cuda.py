"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA GPU.  This file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances: K1 (gather) must match its plain version bit for bit, on
random, smooth and teleported coordinates; K2's
``out`` too, and its gx/gy within 1e-6 of the largest entry; K4 and K5 (the
tile-staged gathers) the same as K1 and K2, whichever path each tile takes;
K3 (splat) sums in int64 fixed point: bit for bit with its float32 plain
version (NaN as NaN), whether a tile's bin is summed by one CTA or split
over several that merge their sums, and the same bits on every launch; K6 (JtJ) sums in
another order than the plain version, rtol 1e-5 with atol 1e-5 of the
largest entry, against the plain version in float32 and in float64 (at
307200 pixels the float64 one alone: the float32 one's own sums stray
past that limit); the forward atol 1e-4 on R and t (1e-5 for the presets
``DeepIC``, ``feature_icp``, ``RGB`` and ``ICP``: ``PRESET_ATOL``, and for the tracker
options, whose ``uncer_prop`` information matrix is held within 1e-4 of its
largest entry); one training step through
the kernels vs through the plain versions: the loss within 1e-5 relative,
each gradient leaf within 5e-3 of its largest entry (the envelope of 12
chained Gauss-Newton solves, ``tests/test_torch_port_train_jax.py``).  The
U_FC forwards (C=28 and, with the ``feature`` sigma, C=49): kernels
against plain within 1e-5.  The non-learned baselines: the ICP ones bit
for bit, the photometric ones (K6) within 1e-4, as the evaluate CLI's
poses in ``chip_smoke.py``.
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


def _assert_same_bits(got, ref):
    """K3 against its float32 plain twin: the same bits, NaN as NaN."""
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


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
    _assert_same_bits(d_op, ref)


def _flat_coords(cuda, B, H, W, N, coords, seed=0):
    """Corner starts and weights [B,N] of N raster samples over an H x W
    plane: ``random`` uniform coordinates over and past the plane,
    ``smooth`` sub-pixel flow as a tracker near convergence makes (every
    K3 tile's corner box is small), ``teleported`` the smooth ones with a
    few samples per image moved half the plane away (their tiles' boxes
    span it), ``offplane`` the smooth ones spread 4x about the centre (most
    samples clamp to the border, whole K3 tiles onto one cell)."""
    rng = np.random.RandomState(seed)
    if coords == "random":
        u = rng.uniform(-3, W + 2, (B, N))
        v = rng.uniform(-3, H + 2, (B, N))
    else:
        y, x = np.divmod(np.arange(N), W)
        phase = rng.rand(B, 1) * 3
        u = x + 0.8 * np.sin(y / 9.0 + phase) + 0.3
        v = y + 0.8 * np.cos(x / 11.0 + phase) + 0.2
        if coords == "offplane":
            u, v = (u - W / 2) * 4 + W / 2, (v - H / 2) * 4 + H / 2
        if coords == "teleported":
            for b in range(B):
                idx = rng.randint(0, N, 6)
                u[b, idx] = (u[b, idx] + W / 2) % (W - 1)
                v[b, idx] = (v[b, idx] + H / 2) % (H - 1)
    u, v = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (u, v))
    return tw._corner_weights((B, H, W, 1), u, v)


# N = H*W - 13: the last row of samples, and K1's last run, are ragged
FLAT_CASES = [(3, 30, 40, 30 * 40 - 13), (2, 120, 160, 120 * 160 - 13)]


@pytest.mark.parametrize("coords", ["random", "smooth", "teleported", "offplane"])
@pytest.mark.parametrize("C", [1, 3, 6, 7, 10, 11, 17, 28, 29, 49])
@pytest.mark.parametrize("B,H,W,N", FLAT_CASES)
def test_gather_kernel_bitwise_on_flat_runs(cuda, coords, C, B, H, W, N):
    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(C)).to(cuda)
    args = _flat_coords(cuda, B, H, W, N, coords)
    out = tk.gather_twohot(F, *args)
    ref = tk.gather_twohot_ref(F, *args)
    torch.cuda.synchronize()
    assert out.shape == (B, C, N)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(out, tk.gather_twohot_grads(F, *args)[0], rtol=0, atol=0)


def _plane(cuda, B, H, W, C, offset):
    """F [B,H,W,C] on the card; with ``offset`` a view one float past an
    aligned allocation, so the kernels' float2 path is refused."""
    buf = torch.randn(B * H * W * C + 1, generator=torch.Generator().manual_seed(C)).to(cuda)
    return (buf[1:] if offset else buf[:-1]).view(B, H, W, C)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("coords", ["random", "smooth", "teleported", "offplane"])
@pytest.mark.parametrize("C", [1, 3, 6, 10, 11, 17, 28, 40, 49])
@pytest.mark.parametrize("B,H,W,N", FLAT_CASES + [(64, 15, 20, 300)])
def test_gather_grads_kernel_on_flat_runs(cuda, offset, coords, C, B, H, W, N):
    """K2 on compact runs (smooth, off the plane, a 15x20 plane), scattered
    ones (random) and launches that mix them (teleported), at both chunk
    sizes of the scattered path (C <= 32 and above), scalar and float2
    loads: ``out`` bit-exact with its plain version and with K1, gx/gy
    within 1e-6 of the largest entry."""
    F = _plane(cuda, B, H, W, C, offset)
    assert (F.data_ptr() % 8 != 0) == offset
    args = _flat_coords(cuda, B, H, W, N, coords)
    n0 = tk.LAUNCHES["gather_twohot_grads"]
    out, gx, gy = tk.gather_twohot_grads(F, *args)
    assert tk.LAUNCHES["gather_twohot_grads"] == n0 + 1
    ref = tk.gather_twohot_grads_ref(F, *args)
    torch.cuda.synchronize()
    assert out.shape == gx.shape == gy.shape == (B, C, N)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(out, tk.gather_twohot(F, *args), rtol=0, atol=0)
    for got, r in zip((gx, gy), ref[1:]):
        torch.testing.assert_close(got, r, rtol=0, atol=1e-6 * r.abs().max().item())


@pytest.mark.parametrize("coords", ["random", "smooth", "teleported", "offplane"])
@pytest.mark.parametrize("C", [1, 2, 3, 6, 10, 11, 17, 28, 40])
@pytest.mark.parametrize("B,H,W,N", FLAT_CASES + [(64, 2, 2, 300), (64, 15, 20, 300)])
def test_splat_kernel_on_flat_tiles(cuda, coords, C, B, H, W, N):
    """Compact, scattered and mixed bins at every channel width the kernel
    compiles (1, 2, 4, 8, 12 and 16 a group; C=17, 28 and 40 in two or three
    groups); on a 2x2 plane one bin holds every sample of an image, and on a
    15x20 plane a few start cells take most of them (the heavy segments)."""
    from deep_prob_feature_track_torch.ops.kernels.splat import splat_bins

    args = _flat_coords(cuda, B, H, W, N, coords, seed=1)
    g = torch.randn(B, C, N, generator=torch.Generator().manual_seed(C)).to(cuda)
    bins = splat_bins(args[0], args[2], H, W, C)
    if H == 2:
        assert bool((bins["counts"] == N).all())
    n0 = tk.LAUNCHES["splat_twohot"]
    d_op = tk.splat_twohot(g, *args, H, W)
    assert tk.LAUNCHES["splat_twohot"] == n0 + 1
    ref = tk.splat_twohot_ref(g, *args, H, W)
    torch.cuda.synchronize()
    assert d_op.shape == (B, H, W, C)
    _assert_same_bits(d_op, ref)


@pytest.mark.parametrize("coords", ["random", "smooth", "teleported", "offplane"])
@pytest.mark.parametrize("C", [1, 10, 11, 28])
@pytest.mark.parametrize("B,H,W,N", [(64, 120, 160, 120 * 160), (64, 2, 2, 300)])
def test_splat_kernel_repeats_its_bits(cuda, coords, C, B, H, W, N):
    """Five launches on one input give the same bits: the bins and the
    merges take another order each run, the int64 sums do not move.
    On the 2x2 plane every sample of an image reaches every cell."""
    args = _flat_coords(cuda, B, H, W, N, coords, seed=2)
    g = torch.randn(B, C, N, generator=torch.Generator().manual_seed(C + 1)).to(cuda)
    outs = [tk.splat_twohot_cuda(g, *args, H, W) for _ in range(5)]
    ref = tk.splat_twohot_ref(g, *args, H, W)
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, outs[0])
    _assert_same_bits(outs[0], ref)


@pytest.mark.parametrize("C", [1, 10, 11])
@pytest.mark.parametrize("coords", ["smooth", "random"])
def test_splat_kernel_non_finite_and_extreme_values(cuda, C, coords):
    """NaN and +-Inf in g (Inf times a zero weight is NaN), a NaN
    coordinate, an all-zero channel, a subnormal one and one near the
    float32 maximum (sums past it are Inf): the twin's bits, NaN as NaN,
    on compact and scattered bins."""
    B, H, W = 7, 30, 40
    N = H * W
    g = torch.randn(B, C, N, generator=torch.Generator().manual_seed(3))
    g[0, 0, 5] = float("nan")
    g[1, 0, 7] = float("inf")
    g[2, C - 1, 9] = -float("inf")
    g[3, 0, 11], g[3, 0, 12] = float("inf"), -float("inf")
    g[4] = 0.0
    g[5] *= 1e-39
    g[6] = g[6].abs().clamp(0.5, 1.0) * 3.3e38
    v0, dv, u0, du = (t.clone() for t in _flat_coords(cuda, B, H, W, N, coords, seed=4))
    du[0, 100] = float("nan")
    du[1, 7], dv[1, 7] = 0.0, 0.0  # g[1, 0, 7] = Inf meets zero weights
    g = g.to(cuda)
    outs = [tk.splat_twohot_cuda(g, v0, dv, u0, du, H, W) for _ in range(3)]
    ref = tk.splat_twohot_ref(g, v0, dv, u0, du, H, W)
    torch.cuda.synchronize()
    assert torch.isnan(ref).any() and torch.isposinf(ref).any() and torch.isneginf(ref).any()
    for out in outs:
        _assert_same_bits(out, ref)


def test_splat_launch_mixes_staged_and_global_tiles(cuda):
    """At 120x160, C=10 no smooth, random or teleported bin splits over
    CTAs, while off the plane the corner tiles' bins (the samples clamped
    onto the corner cells) split and the others do not; on a 2x2 plane
    with 19,200 samples an image every bin splits, and where the samples
    crowd five tiles of each image, more bins than the merge slots, the
    last ones in tile order stay whole.  Split and unsplit bins give the
    twin's bits, the same on every launch."""
    from deep_prob_feature_track_torch.ops.kernels.splat import SLOTS_PER_IMAGE, splat_bins

    N = 120 * 160
    for coords in ("random", "smooth", "teleported", "offplane"):
        args = _flat_coords(cuda, 2, 120, 160, N, coords)
        bins = splat_bins(args[0], args[2], 120, 160, 10)
        if coords == "offplane":
            assert 0.0 < bins["split_share"] < 1.0 and bool(bins["split"][:, 0, 0].all())
        else:
            assert bins["split_share"] == 0.0, coords
    rng = np.random.RandomState(5)
    crowded = (np.full((2, N), 0.5), rng.uniform(0, 159, (2, N)))  # row 0 of 5 tiles, 40x160
    for H, W, (v, u) in ((2, 2, (np.zeros((2, N)), np.zeros((2, N)))), (40, 160, crowded)):
        v, u = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (v, u))
        args = tw._corner_weights((2, H, W, 1), u, v)
        bins = splat_bins(args[0], args[2], H, W, 10)
        split = int(bins["split"].sum())
        assert split == (2 if H == 2 else 2 * SLOTS_PER_IMAGE), bins["split"]
        g = torch.randn(2, 10, N, generator=torch.Generator().manual_seed(H)).to(cuda)
        outs = [tk.splat_twohot_cuda(g, *args, H, W) for _ in range(3)]
        ref = tk.splat_twohot_ref(g, *args, H, W)
        torch.cuda.synchronize()
        for out in outs:
            assert torch.equal(out, outs[0])
        _assert_same_bits(outs[0], ref)


def test_splat_kernel_on_many_tiles_and_no_samples(cuda):
    """A plane of more than 4096 tiles (the bin passes count in global
    memory rather than in a shared histogram) against the twin's bits, and
    a launch with no samples, which writes every cell as +0."""
    from deep_prob_feature_track_torch.ops.kernels.splat import TILE_H, TILE_W

    B, H, W, C, N = 2, 272, 4000, 3, 6000
    assert -(-H // TILE_H) * -(-W // TILE_W) > 4096
    rng = np.random.RandomState(7)
    u, v = (torch.from_numpy(rng.uniform(-2, s + 1, (B, N)).astype(np.float32)).to(cuda)
            for s in (W, H))
    args = tw._corner_weights((B, H, W, 1), u, v)
    g = torch.randn(B, C, N, generator=torch.Generator().manual_seed(8)).to(cuda)
    _assert_same_bits(tk.splat_twohot_cuda(g, *args, H, W), tk.splat_twohot_ref(g, *args, H, W))
    empty = [torch.zeros(B, 0, dtype=t, device=cuda)
             for t in (torch.int32, torch.float32, torch.int32, torch.float32)]
    out = tk.splat_twohot_cuda(torch.zeros(B, C, 0, device=cuda), *empty, 30, 40)
    torch.cuda.synchronize()
    assert out.shape == (B, 30, 40, C) and not bool(out.view(torch.int32).any())


@pytest.mark.parametrize("B,C,HW", [(8, 8, 19200), (8, 1, 19200), (8, 8, 300), (2, 3, 2049),
                                    (1, 8, 1)])
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


def _jtj_inputs(cuda, B, C, HW, offset):
    """alpha, beta, res [B,C,HW] and u, v [B,HW,6] made on the card; with
    ``offset`` each a view one float past an aligned allocation, so the
    kernel's float4 path is refused."""
    g = torch.Generator(device=cuda).manual_seed(HW + B)
    out = []
    for shape in ((B, C, HW),) * 3 + ((B, HW, 6),) * 2:
        n = int(np.prod(shape))
        buf = torch.randn(n + 1, generator=g, device=cuda)
        out.append((buf[1:] if offset else buf[:-1]).view(shape))
    return out


def _device_kernels(fn, attempts: int = 3):
    """Names of the device kernels that one call of ``fn`` ran, from a
    ``torch.profiler`` trace.  A trace that holds no device event at all
    shows nothing (the profiler now and then records none): it is taken
    again, up to ``attempts`` traces in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return names


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("HW", [1, 300, 2049, 19200, 307200])
def test_jtj_kernel_one_deterministic_launch(cuda, offset, B, HW):
    """Every cluster size the launch picks (1 to 16 CTAs an image), float4
    and scalar loads: within the plain version's tolerance, symmetric, the
    same bits on a second run, and one device kernel per call."""
    args = _jtj_inputs(cuda, B, 8, HW, offset)
    jtj, jtr = tk.fused_jtj_jtr(*args, sign=-1.0)
    f32 = tk.jtj_jtr_ref(*args, sign=-1.0)
    f64 = [t.float() for t in tk.jtj_jtr_ref(*[a.double() for a in args], sign=-1.0)]
    # at 307200 pixels the float32 plain version's own sums stray past the
    # limit from the float64 ones: the kernel is held to those alone there
    for ref in (f64, f32) if HW < 307200 else (f64,):
        for got, r in zip((jtj, jtr), ref):
            torch.testing.assert_close(got, r, rtol=1e-5, atol=1e-5 * r.abs().max().item())
    torch.testing.assert_close(jtj, jtj.transpose(1, 2), rtol=0, atol=0)
    again = tk.fused_jtj_jtr(*args, sign=-1.0)
    assert torch.equal(again[0], jtj) and torch.equal(again[1], jtr)
    names = _device_kernels(lambda: tk.fused_jtj_jtr(*args, sign=-1.0))
    assert len(names) == 1 and "fused_jtj_jtr" in names[0], names


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
    motion (every tile stages its box, K4's where the grid samples the plane
    about 1:1), ``global`` uniform random coordinates
    (no tile does), ``mixed`` the smooth ones with a few samples teleported
    across the plane (one launch takes both paths), ``offplane`` the smooth
    ones zoomed out 4x about the centre (most samples clamp to the border)
    with a few NaN coordinates and a few starts at the int32 extremes."""
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
    if coords == "offplane":
        u, v = (u - W / 2) * 4 + W / 2, (v - H / 2) * 4 + H / 2
        for m in (u, v):
            m[rng.randint(0, B, 5), 0, rng.randint(0, Hs, 5), rng.randint(0, Ws, 5)] = np.nan
    u, v = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (u, v))
    maps = [t.reshape(B, Hs, Ws) for t in tw._corner_weights((B, H, W, 1), u, v)]
    if coords == "offplane":  # starts that no clamp of the coordinates made
        for m, extreme in ((maps[0], -2**31), (maps[2], 2**31 - 1), (maps[0], 2**31 - 1)):
            m[rng.randint(0, B, 3), rng.randint(0, Hs, 3), rng.randint(0, Ws, 3)] = extreme
    return maps


@pytest.mark.parametrize("coords", ["smooth", "global", "mixed"])
@pytest.mark.parametrize("B,H,W,C,Hs,Ws", [
    (4, 240, 320, 10, 240, 320),  # K5 at level 1 of the 640x480 step
    (2, 240, 320, 17, 240, 320),  # the un-slimmed operand
    (2, 96, 448, 10, 83, 301),    # a sample grid that is not a multiple of the tile
    (8, 480, 640, 6, 480, 640),   # K4 on the ICP warp of the 640x480 feature_icp forward
    (4, 480, 640, 6, 480, 640),   # K5 on it in the 640x480 feature_icp step
    (8, 480, 640, 11, 480, 640),  # K4 on the masked U_IC operand (an object mask)
    (4, 480, 640, 11, 480, 640),  # K5 on it
    (8, 480, 640, 7, 480, 640),   # K4 on the masked ICP operand
])
def test_tiles_kernels_match_plain(cuda, coords, B, H, W, C, Hs, Ws):
    from deep_prob_feature_track_torch.ops.kernels import tiles

    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(5)).to(cuda)
    maps = _tile_maps(cuda, B, H, W, Hs, Ws, coords)
    # K4's window holds a smooth tile's box where the grid samples the plane
    # about 1:1; the 83x301 grid, stretched 1.5x across the 96x448 plane,
    # leaves it in most tiles
    stretched = (Hs, Ws) != (H, W)
    for share, smooth in ((tiles.staged_share(maps[0], maps[2], H, W, C), not stretched),
                          (tiles.grads_staged_share(maps[0], maps[2], H, W, C), True)):
        assert {"smooth": share == 1.0 if smooth else 0.0 < share < 1.0,
                "global": share == 0.0, "mixed": 0.0 < share < 1.0}[coords], share
    n0 = dict(tk.LAUNCHES)
    out = tk.gather_tiles(F, *maps)
    got = tk.gather_tiles_grads(F, *maps)
    assert tk.LAUNCHES["gather_tiles"] == n0["gather_tiles"] + 1
    assert tk.LAUNCHES["gather_tiles_grads"] == n0["gather_tiles_grads"] + 1
    ref = tk.gather_tiles_grads_ref(F, *maps)
    k1 = tk.gather_twohot_cuda(F, *[m.reshape(B, -1) for m in maps])
    torch.cuda.synchronize()
    assert out.shape == (B, C, Hs * Ws)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(out, tk.gather_tiles_ref(F, *maps), rtol=0, atol=0)
    torch.testing.assert_close(out, k1, rtol=0, atol=0)
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6 * r.abs().max().item())


def _k4_matches_plain_and_k1(F, maps):
    """K4 on F and the corner maps, launched once: bit for bit its plain
    version and K1 on the flattened maps (NaN where they are NaN)."""
    B = F.shape[0]
    n0 = tk.LAUNCHES["gather_tiles"]
    out = tk.gather_tiles(F, *maps)
    assert tk.LAUNCHES["gather_tiles"] == n0 + 1
    ref = tk.gather_tiles_ref(F, *maps)
    k1 = tk.gather_twohot_cuda(F, *[m.reshape(B, -1) for m in maps])
    torch.cuda.synchronize()
    assert out.shape == (B, F.shape[3], maps[0][0].numel())
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(out, k1, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("C", [1, 3, 6, 7, 10, 11, 17, 28, 29])
@pytest.mark.parametrize("coords", ["smooth", "mixed", "offplane"])
@pytest.mark.parametrize("B,H,W,Hs,Ws,smooth", [
    (1, 480, 640, 480, 640, "all"),   # 600 tiles (1200 at C=17): more than the grid's CTAs
    (2, 90, 448, 90, 440, "all"),     # a ragged sample grid, 84 tiles (168 at C=17)
    (8, 96, 448, 83, 301, "some"),    # ragged and stretched 1.5x: most boxes miss the window
    (2, 180, 283, 170, 260, "none"),  # rows of W*C floats that are not whole chunks: no window
])
def test_gather_tiles_ring_matches_plain_and_k1(cuda, C, coords, B, H, W, Hs, Ws, smooth):
    """K4 at the channel counts of every warp, on smooth coordinates (every
    tile whose box lies in the window stages), teleported samples (staged
    and global tiles in one launch) and coordinates off the plane, NaN or at
    the int32 extremes."""
    from deep_prob_feature_track_torch.ops.kernels import tiles

    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(C)).to(cuda)
    maps = _tile_maps(cuda, B, H, W, Hs, Ws, coords, seed=C)
    share = tiles.staged_share(maps[0], maps[2], H, W, C)
    if smooth == "none":
        assert share == 0.0, share
    elif coords == "smooth" and smooth == "all":
        assert share == 1.0, share
    else:
        assert 0.0 < share < 1.0, share
    _k4_matches_plain_and_k1(F, maps)


@pytest.mark.parametrize("C", [3, 10])
def test_gather_tiles_on_an_unaligned_plane(cuda, C):
    """A plane that is not 16-byte aligned stages no box: every tile reads
    its corners from device memory, bit for bit as K1."""
    B, H, W = 2, 96, 160
    flat = torch.randn(B * H * W * C + 1, generator=torch.Generator().manual_seed(2)).to(cuda)
    F = flat[1:].view(B, H, W, C)
    assert F.data_ptr() % 16 != 0 and F.is_contiguous()
    _k4_matches_plain_and_k1(F, _tile_maps(cuda, B, H, W, H, W, "smooth", seed=C))


def window_maps(B, H, W, Hs, Ws, C):
    """Identity corner starts [B,Hs,Ws] int32, except in image 0's first
    three tiles: the first spans a box that fills K4's window exactly (its
    ``tile_rows(C) + 3`` rows, and as many columns as the 128-byte chunks
    that 35 cells can span hold), the second one row more, the third one
    column more.  Returns (v0, u0) on the CPU and the number of tiles that
    take the global path (2)."""
    from deep_prob_feature_track_torch.ops.kernels import tiles

    th = tiles.tile_rows(C)
    rows, cols = th + 3, 32 * -(-(35 * C + 31) // 32) // C
    assert Ws > 2 * tiles.TILE_W and Hs >= th and H >= rows + 2 and W >= 64 + cols + 2
    v0 = np.broadcast_to(np.arange(Hs, dtype=np.int32)[:, None], (B, Hs, Ws)).copy()
    u0 = np.broadcast_to(np.arange(Ws, dtype=np.int32)[None, :], (B, Hs, Ws)).copy()
    for i, (r, c) in enumerate(((rows, cols), (rows + 1, cols), (rows, cols + 1))):
        x0 = ulo = i * tiles.TILE_W  # ulo * C on a chunk: the window starts at the box
        v0[0, :th, x0:x0 + tiles.TILE_W] = 1
        u0[0, :th, x0:x0 + tiles.TILE_W] = ulo
        v0[0, 1, x0 + 1] = 1 + r - 2
        u0[0, 1, x0 + 1] = ulo + c - 2
    return (v0, u0), 2


@pytest.mark.parametrize("C", [6, 10])
def test_gather_tiles_boxes_at_and_just_over_capacity(cuda, C):
    """A tile whose box fills K4's window exactly stages; one row or one
    column more sends its tile to the global path; all are bit-exact."""
    from deep_prob_feature_track_torch.ops.kernels import tiles

    B, H, W, Hs, Ws = 2, 96, 160, 40, 80
    (v0, u0), n_global = window_maps(B, H, W, Hs, Ws, C)
    g = torch.Generator().manual_seed(0)
    maps = [torch.from_numpy(v0), torch.rand(B, Hs, Ws, generator=g),
            torch.from_numpy(u0), torch.rand(B, Hs, Ws, generator=g)]
    n_tiles = B * -(-Hs // tiles.tile_rows(C)) * -(-Ws // tiles.TILE_W)
    assert tiles.staged_share(maps[0], maps[2], H, W, C) == 1.0 - n_global / n_tiles
    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(1)).to(cuda)
    _k4_matches_plain_and_k1(F, [m.to(cuda) for m in maps])


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


# per forward at 120x160: feature_icp adds an ICP warp (C=6) per iteration;
# RGB warps the gray image and the occlusion depth (C=1) for 3 residuals a
# level, ICP its vertices and normals (C=6) once an iteration, RGB+ICP the
# U_IC operand (C=3) and the ICP operand; DeepIC does RGB's and warps both
# maps once more an iteration for its 10 folded damping samples, and
# upsamples the prior weights at levels 2, 1 and 0
PRESET_LAUNCHES = {
    "DeepIC": {"gather_twohot": 51},
    "feature_icp": {"gather_twohot": 24, "fused_jtj_jtr": 12},
    "RGB": {"gather_twohot": 24},
    "ICP": {"gather_twohot": 12},
    "RGB+ICP": {"gather_twohot": 24, "fused_jtj_jtr": 12},
}


def _launches(**n):
    return {k: n.get(k, 0) for k in tk.LAUNCHES}


# kernel against plain forward on R and t.  RGB+ICP on these uniform-noise
# inputs is held to the feature forward's 1e-4: the whole gap is K6's
# rounding, which is closer to float64 sums than the plain einsums', and
# flips pixels of the ICP occlusion mask (|T v0 - v1_r| > 0.1) from level 1
# on (test_rgb_icp_forward_gap_is_k6_alone; scripts/torch_rgb_icp_gap.py
# prints the gap, 3.3e-5 on an H100, and the flipped pixels)
PRESET_ATOL = {"DeepIC": 1e-5, "feature_icp": 1e-5, "RGB": 1e-5, "ICP": 1e-5, "RGB+ICP": 1e-4}


@pytest.mark.parametrize("preset", sorted(PRESET_LAUNCHES))
def test_preset_forward_kernels_match_plain_on_card(cuda, preset):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    batch = example_batch(8, 120, 160, seed=3, device=cuda)
    kern = build_tracker(preset, device=cuda)
    plain = build_tracker(preset, device=cuda, plain_kernels=True)
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch)
        assert tk.LAUNCHES == _launches(**PRESET_LAUNCHES[preset])
        Rp, tp = plain(*batch)
    assert tk.LAUNCHES == _launches(**PRESET_LAUNCHES[preset])
    torch.testing.assert_close(R, Rp, rtol=0, atol=PRESET_ATOL[preset])
    torch.testing.assert_close(t, tp, rtol=0, atol=PRESET_ATOL[preset])
    eye = torch.eye(3, device=cuda).expand_as(R)
    assert (R.transpose(1, 2) @ R - eye).abs().max() < 1e-4
    assert np.isfinite(t.cpu().numpy()).all()


# a masked forward's launches (an object mask in both frames): as unmasked
# where the mask rides in the operand (U_IC C=11, the fused ICP term C=7,
# U_FC C=29) or is ignored (ICP); the IC residual warps the frame-1 mask in a
# gather of its own
MASKED_LAUNCHES = {
    ("feature", ()): {"gather_twohot": 12, "fused_jtj_jtr": 12},
    ("feature_icp", ()): {"gather_twohot": 24, "fused_jtj_jtr": 12},
    ("DeepIC", ()): {"gather_twohot": 75},
    ("feature", ("direction=forward",)): {"gather_tiles": 3, "gather_twohot": 9},
    ("RGB", ()): {"gather_twohot": 36},
    ("ICP", ()): {"gather_twohot": 12},
    ("RGB+ICP", ()): {"gather_twohot": 24, "fused_jtj_jtr": 12},
}


@pytest.mark.parametrize("preset,overrides", sorted(MASKED_LAUNCHES))
def test_masked_forward_kernels_match_plain_on_card(cuda, preset, overrides):
    """Every preset with object masks (an ellipse in frame 0, a shifted one
    in frame 1): kernels against plain within 1e-4 on R and t, the launch
    counts of ``MASKED_LAUNCHES``."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    batch = example_batch(8, 120, 160, seed=3, device=cuda)
    yy = torch.arange(120, device=cuda)[:, None].float()
    xx = torch.arange(160, device=cuda)[None, :].float()
    masks = [((((yy - 60 - dy) / 40) ** 2 + ((xx - 80 - dx) / 55) ** 2) < 1).expand(8, 1, 120, 160)
             for dy, dx in ((0, 0), (4, 6))]
    kern = build_tracker(preset, device=cuda, overrides=overrides)
    plain = build_tracker(preset, device=cuda, plain_kernels=True, overrides=overrides)
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch, obj_mask0=masks[0], obj_mask1=masks[1])
        assert tk.LAUNCHES == _launches(**MASKED_LAUNCHES[(preset, overrides)])
        Rp, tp = plain(*batch, obj_mask0=masks[0], obj_mask1=masks[1])
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-4)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-4)
    assert np.isfinite(t.cpu().numpy()).all()


def test_rgb_icp_forward_gap_is_k6_alone(cuda, monkeypatch):
    """The RGB+ICP forward's kernel-vs-plain gap comes from K6 alone: with
    the plain K6 the kernel gathers give the plain forward bit for bit, with
    K6 the plain gathers give the kernel forward bit for bit, and K6's sums
    are no farther from float64 sums of the same inputs than the plain
    version's."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch
    from deep_prob_feature_track_torch.solvers import jacobians

    batch = example_batch(8, 120, 160, seed=3, device=cuda)
    k6_inputs = []

    def k6(*a, **k):
        k6_inputs.append([x.clone() for x in a])
        return tk.fused_jtj_jtr_cuda(*a, **k)

    def pose(plain, swap_k6=False):
        with monkeypatch.context() as mp:
            if swap_k6:  # the other route for the normal equations only
                mp.setattr(jacobians, "jtj_jtr_ref" if plain else "fused_jtj_jtr",
                           k6 if plain else tk.jtj_jtr_ref)
            with torch.inference_mode():
                return torch.cat([x.flatten(1) for x in build_tracker(
                    "RGB+ICP", device=cuda, plain_kernels=plain)(*batch)], 1)

    kern, plain = pose(False), pose(True)
    assert torch.equal(pose(False, swap_k6=True), plain)
    assert torch.equal(pose(True, swap_k6=True), kern)
    assert len(k6_inputs) == 12
    for args in k6_inputs:
        ref = tk.jtj_jtr_ref(*[x.double() for x in args])
        for got_k6, got_plain, r in zip(tk.fused_jtj_jtr_cuda(*args), tk.jtj_jtr_ref(*args), ref):
            assert (got_k6.double() - r).abs().max() <= (got_plain.double() - r).abs().max()


def test_feature_icp_train_step_on_card(cuda):
    """One loss and backward of feature_icp through the kernels and through
    their plain versions at 60x80: K2 24 times (the feature and the ICP
    warps), K3 12 (the ICP operand needs no cotangent), K6 12."""
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    batch = tt.synthetic_batch(4, 60, 80, seed=3, device=cuda)
    results = []
    for plain in (False, True):
        net = LeastSquareTracking(get_preset("feature_icp"), plain_kernels=plain)
        state = tt.create_train_state(net, tt.TrainConfig(), seed=1, device=cuda)
        tk.reset_launches()
        loss = tt.compute_loss(state.net, tt.TrainConfig(), batch)
        loss.backward()
        torch.cuda.synchronize()
        if not plain:
            assert tk.LAUNCHES == _launches(gather_twohot_grads=24, splat_twohot=12,
                                            fused_jtj_jtr=12)
        results.append((loss.item(), {k: p.grad for k, p in net.named_parameters()}))
    assert tk.LAUNCHES == _launches()  # the plain step launched nothing
    (loss, grads), (loss_p, grads_p) = results
    assert np.isfinite(loss) and abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for key, ref in grads_p.items():
        torch.testing.assert_close(grads[key], ref, rtol=0,
                                   atol=5e-3 * ref.abs().max().item(), msg=key)


def test_feature_icp_640x480_routes_the_icp_warp_through_the_tile_kernels(cuda):
    """At 640x480 the ICP operand (C=6) takes K4 at level 0 of the forward
    and K5 at level 0 of the step, as the JAX package routes it; at level 1
    of the step it takes K2 where the feature operand (C=10) takes K5."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    batch = example_batch(2, 480, 640, seed=3, device=cuda)
    kern = build_tracker("feature_icp", device=cuda)
    plain = build_tracker("feature_icp", device=cuda, plain_kernels=True)
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch)
        assert tk.LAUNCHES == _launches(gather_tiles=6, gather_twohot=18, fused_jtj_jtr=12)
        Rp, tp = plain(*batch)
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)

    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature_icp")), cfg,
                                  device=cuda)
    step = tt.make_train_step(cfg, steps_per_epoch=100)
    tk.reset_launches()
    state, metrics = step(state, tt.synthetic_batch(2, 480, 640, seed=4, device=cuda))
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    assert tk.LAUNCHES == _launches(gather_tiles_grads=9, gather_twohot_grads=15,
                                    splat_twohot=12, fused_jtj_jtr=12)


def test_deepic_train_step_on_card(cuda):
    """One loss and backward of DeepIC through the kernels and through
    their plain versions at 60x80: K1 once (level 3's first occlusion
    depth), K2 50 times (12 a level and 3 upsamples), K3 27 (the 6 x1
    warps a level and the upsamples)."""
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    batch = tt.synthetic_batch(4, 60, 80, seed=3, device=cuda)
    results = []
    for plain in (False, True):
        net = LeastSquareTracking(get_preset("DeepIC"), plain_kernels=plain)
        state = tt.create_train_state(net, tt.TrainConfig(), seed=1, device=cuda)
        tk.reset_launches()
        loss = tt.compute_loss(state.net, tt.TrainConfig(), batch)
        loss.backward()
        torch.cuda.synchronize()
        if not plain:
            assert tk.LAUNCHES == _launches(gather_twohot=1, gather_twohot_grads=50,
                                            splat_twohot=27)
        results.append((loss.item(), {k: p.grad for k, p in net.named_parameters()}))
    assert tk.LAUNCHES == _launches()  # the plain step launched nothing
    (loss, grads), (loss_p, grads_p) = results
    assert np.isfinite(loss) and abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for key, ref in grads_p.items():
        torch.testing.assert_close(grads[key], ref, rtol=0,
                                   atol=5e-3 * ref.abs().max().item(), msg=key)


def _upsample_maps(cuda, B, h, w):
    """The corner maps of the align-corners upsample of an h x w plane to
    2h x 2w (``ops/image.py::bilinear_resize_align``): 4 samples a cell."""
    H2, W2 = 2 * h, 2 * w
    v = (torch.arange(H2, dtype=torch.float32, device=cuda) * ((h - 1.0) / (H2 - 1.0)))
    u = (torch.arange(W2, dtype=torch.float32, device=cuda) * ((w - 1.0) / (W2 - 1.0)))
    u = u[None, None, None, :].expand(B, 1, H2, W2)
    v = v[:, None][None, None].expand(B, 1, H2, W2)
    return list(tw._corner_weights((B, h, w, 1), u, v))


def _folded_maps(cuda, B, h, w, seed=0):
    """Corner maps of smooth sub-pixel motion over S*B planes of h x w."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32, device=cuda)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=cuda)[None, :]
    phase = torch.rand(B, 1, 1, 1, generator=g, device=cuda) * 3
    u = xx + 0.8 * torch.sin(yy / 9.0 + phase) + 0.3
    v = yy + 0.8 * torch.cos(xx / 11.0 + phase) + 0.2
    return list(tw._corner_weights((B, h, w, 1), u, v))


# (planes, plane h x w, kind): the 10 folded damping samples of B=8 (eval)
# and B=64 (training) at the 120x160 levels, and the prior weights'
# upsamples from 15x20, 30x40 and 60x80
DEEPIC_SHAPES = ([(80, h, w, "folded") for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
                 + [(640, 120, 160, "folded"), (640, 15, 20, "folded")]
                 + [(b, h, w, "upsample") for b in (8, 64)
                    for h, w in ((15, 20), (30, 40), (60, 80))])


@pytest.mark.parametrize("P,h,w,kind", DEEPIC_SHAPES)
def test_deepic_shapes_match_plain(cuda, P, h, w, kind):
    """K1 bit-exact, K2's ``out`` bit-exact and gx/gy within 1e-6, and K3
    within 1e-5 of the largest entry, against their plain versions at the
    DeepIC path's new shapes (C=1)."""
    maps = (_upsample_maps(cuda, P, h, w) if kind == "upsample"
            else _folded_maps(cuda, P, h, w, seed=P + h))
    g = torch.Generator(device=cuda).manual_seed(h)
    F = torch.randn(P, h, w, 1, generator=g, device=cuda)
    assert torch.equal(tk.gather_twohot_cuda(F, *maps), tk.gather_twohot_ref(F, *maps))
    got, ref = tk.gather_twohot_grads_cuda(F, *maps), tk.gather_twohot_grads_ref(F, *maps)
    assert torch.equal(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6 * r.abs().max().item())
    cot = torch.randn(P, 1, maps[0].shape[1], generator=g, device=cuda)
    _assert_same_bits(tk.splat_twohot_cuda(cot, *maps, h, w), tk.splat_twohot_ref(cot, *maps, h, w))


# ------------------------------------------------------------------ U_FC
#
# The forward-compositional track warps one operand an iteration: the target
# depth, features, sigma and the gradients of both, C=28 with the slimmed
# 1-channel sigma and C=49 with the 8-channel "feature" sigma.

C_UFC = 28
UFC = ["direction=forward"]


def _ufc_maps(cuda, B, H, W, seed, teleported=False):
    """Corner maps [B,H,W] of U_FC's forward warp of a synthetic depth map
    under a small motion, with a pixel of zero depth every 37 rows and 41
    columns (it projects from the translation alone, far from its
    neighbours: its tile takes K4's global path); with ``teleported`` 6
    samples an image moved half the plane away."""
    from deep_prob_feature_track_torch.geometry.lie import exp_so3
    from deep_prob_feature_track_torch.solvers.trust_region import _warp_forward_depth
    from deep_prob_feature_track_torch.training import train as tt

    batch = tt.synthetic_batch(B, H, W, seed=seed, device=cuda)
    depth = batch["depth0"]
    depth[:, :, ::37, ::41] = 0.0
    g = torch.Generator().manual_seed(seed)
    pose = (exp_so3(torch.randn(B, 3, generator=g) * 0.01).to(cuda),
            (torch.randn(B, 3, generator=g) * 0.02).to(cuda))
    u, v = _warp_forward_depth(depth, pose, batch["calib"])[:2]
    if teleported:
        rng = np.random.RandomState(seed)
        for b in range(B):
            y, x = rng.randint(0, H, 6), rng.randint(0, W, 6)
            u[b, 0, y, x] = (u[b, 0, y, x] + W / 2) % (W - 1)
            v[b, 0, y, x] = (v[b, 0, y, x] + H / 2) % (H - 1)
    return [t.reshape(B, H, W) for t in tw._corner_weights((B, H, W, 1), u, v)]


@pytest.mark.parametrize("teleported", [False, True])
@pytest.mark.parametrize("B,H,W", [(8, 120, 160), (8, 480, 640), (8, 240, 320)])
def test_gather_tiles_on_ufc_coordinates(cuda, teleported, B, H, W):
    """K4 at C=28 (8-row tiles) on the planes where U_FC takes it (120x160
    level 0, 640x480 levels 0-2): staged and global tiles in one launch,
    bit for bit its plain version and K1."""
    from deep_prob_feature_track_torch.ops.kernels import tiles

    assert tiles.tile_rows(C_UFC) == 8 and tiles.has_window(W, C_UFC)
    assert tiles.use_tiles("eval", H, W, C_UFC, H, W)
    maps = _ufc_maps(cuda, B, H, W, seed=H + teleported, teleported=teleported)
    assert 0.0 < tiles.staged_share(maps[0], maps[2], H, W, C_UFC) < 1.0
    F = torch.randn(B, H, W, C_UFC, generator=torch.Generator().manual_seed(W)).to(cuda)
    _k4_matches_plain_and_k1(F, maps)


@pytest.mark.parametrize("C", [C_UFC, 49])
@pytest.mark.parametrize("H,W", [(120, 160), (60, 80), (30, 40), (15, 20)])
def test_ufc_shapes_match_plain(cuda, C, H, W):
    """K1 (B=8) bit-exact, K2 (B=64) ``out`` bit-exact and gx/gy within 1e-6
    of the largest entry, and K3 (B=64, C=28) within 1e-5 of it, at U_FC's
    120x160 levels on its forward-warp coordinates."""
    maps = [m.reshape(8, -1) for m in _ufc_maps(cuda, 8, H, W, seed=C + H)]
    F = torch.randn(8, H, W, C, generator=torch.Generator().manual_seed(C)).to(cuda)
    assert torch.equal(tk.gather_twohot_cuda(F, *maps), tk.gather_twohot_ref(F, *maps))
    maps = [m.reshape(64, -1) for m in _ufc_maps(cuda, 64, H, W, seed=C + W)]
    F = torch.randn(64, H, W, C, generator=torch.Generator().manual_seed(C + 1)).to(cuda)
    got, ref = tk.gather_twohot_grads_cuda(F, *maps), tk.gather_twohot_grads_ref(F, *maps)
    assert torch.equal(got[0], ref[0])
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-6 * r.abs().max().item())
    if C == C_UFC:
        cot = torch.randn(64, C, H * W, generator=torch.Generator().manual_seed(H)).to(cuda)
        _assert_same_bits(tk.splat_twohot_cuda(cot, *maps, H, W),
                          tk.splat_twohot_ref(cot, *maps, H, W))


# per forward: K4 at the levels whose C=28 operand the JAX tile gate takes
# (120x160 level 0; 480x640 levels 0-2), K1 elsewhere; C=49 fits no tile
# budget.  The systems are weighted: no K6
UFC_FORWARDS = {
    "U_FC": (UFC, 120, 160, {"gather_tiles": 3, "gather_twohot": 9}),
    "U_FC_480x640": (UFC, 480, 640, {"gather_tiles": 9, "gather_twohot": 3}),
    "U_FC_feature_sigma": (UFC + ["uncertainty_type=feature"], 120, 160, {"gather_twohot": 12}),
}


@pytest.mark.parametrize("name", sorted(UFC_FORWARDS))
def test_ufc_forward_kernels_match_plain_on_card(cuda, name):
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    overrides, H, W, launches = UFC_FORWARDS[name]
    batch = example_batch(8 if H == 120 else 2, H, W, seed=3, device=cuda)
    kern = build_tracker("feature", device=cuda, overrides=overrides)
    plain = build_tracker("feature", device=cuda, plain_kernels=True, overrides=overrides)
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch)
        assert tk.LAUNCHES == _launches(**launches)
        Rp, tp = plain(*batch)
    assert tk.LAUNCHES == _launches(**launches)
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)
    eye = torch.eye(3, device=cuda).expand_as(R)
    assert (R.transpose(1, 2) @ R - eye).abs().max() < 1e-4
    assert np.isfinite(t.cpu().numpy()).all()


@pytest.mark.parametrize("mest", [False, True])
def test_ufc_train_step_on_card(cuda, mest):
    """One loss and backward of U_FC at 64x80 (B=4) through the kernels
    and through their plain versions: K2 and K3 12 times, and with the
    learned estimator K2 24 and K3 21 times (its upsamples of the prior
    weights)."""
    from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    overrides = UFC + (["mest_type=MultiScale2w", "train_init_pose=false"] if mest else [])
    expected = (_launches(gather_twohot_grads=24, splat_twohot=21) if mest
                else _launches(gather_twohot_grads=12, splat_twohot=12))
    batch = tt.synthetic_batch(4, 64, 80, seed=5, device=cuda)
    results = []
    for plain in (False, True):
        net = LeastSquareTracking(apply_overrides(get_preset("feature"), overrides),
                                  plain_kernels=plain)
        state = tt.create_train_state(net, tt.TrainConfig(), seed=1, device=cuda)
        tk.reset_launches()
        loss = tt.compute_loss(state.net, tt.TrainConfig(), batch)
        loss.backward()
        torch.cuda.synchronize()
        assert tk.LAUNCHES == (_launches() if plain else expected)
        results.append((loss.item(), {k: p.grad for k, p in net.named_parameters()}))
    (loss, grads), (loss_p, grads_p) = results
    assert np.isfinite(loss) and abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for key, ref in grads_p.items():
        torch.testing.assert_close(grads[key], ref, rtol=0,
                                   atol=5e-3 * ref.abs().max().item(), msg=key)


def test_evaluate_cli_on_card(cuda, tmp_path):
    """``apps.evaluate.main`` on a written 640x480 TUM-format sequence of 5
    frames at ``--image_resize 0.25`` (120x160), B=2, keyframes 1 and 2:
    K1 and K6 12 times a batch (3 batches), nothing else; finite metrics."""
    import os
    import pickle
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import write_tum_sequence
    from deep_prob_feature_track_torch.apps import evaluate

    seq = str(tmp_path / "seq")
    write_tum_sequence(seq, n=5)
    tk.reset_launches()
    assert evaluate.main(["--data_root", "", "--trajectory", seq, "--keyframes", "1,2",
                          "--batch_size", "2", "--output_dir", str(tmp_path / "out")]) == 0
    torch.cuda.synchronize()
    assert tk.LAUNCHES == _launches(gather_twohot=36, fused_jtj_jtr=36)
    assert (tmp_path / "out" / "nolearning_feature" / "summary.csv").is_file()
    for kf, n in ((1, 4), (2, 2)):
        with open(f"{seq}_keyframe_{kf}.pkl", "rb") as f:
            info = pickle.load(f)
        assert info["R_est"].shape == (n, 3, 3)
        assert np.isfinite(info["epes"]).all() and np.isfinite(info["angular_error"]).all()


BASELINE_LAUNCHES = {  # per batch: 40 iterations (94 for the Iter_ plans)
    "ICP": {"gather_twohot": 40}, "Point2Point": {"gather_twohot": 40},
    "Iter_Point2Plane": {"gather_twohot": 94},
    "RGBD": {"gather_twohot": 80, "fused_jtj_jtr": 40},
    "ColorICP": {"gather_twohot": 40, "fused_jtj_jtr": 40},
    "Iter_ColorICP": {"gather_twohot": 94, "fused_jtj_jtr": 94},
}


@pytest.mark.parametrize("name", sorted(BASELINE_LAUNCHES))
def test_baseline_kernels_match_plain_on_card(cuda, name):
    """A non-learned baseline at 120x160 B=8 on smooth scenes through the
    kernels and through their plain versions: the ICP ones (K1 alone)
    bit for bit, the photometric ones within 1e-4 (K6's sum order moves
    their 40-94 solves); the launches per batch pinned."""
    from deep_prob_feature_track_torch.apps.baselines import make_baseline
    from deep_prob_feature_track_torch.training.train import synthetic_batch

    batch = synthetic_batch(8, 120, 160, seed=2, device=cuda)
    args = [batch[k] for k in ("color0", "depth0", "color1", "depth1", "calib")]
    tk.reset_launches()
    R, t = make_baseline(name).batch_track(*args)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == _launches(**BASELINE_LAUNCHES[name])
    R_p, t_p = make_baseline(name, plain=True).batch_track(*args)
    atol = 1e-4 if "fused_jtj_jtr" in BASELINE_LAUNCHES[name] else 0.0
    torch.testing.assert_close(R, R_p, rtol=0, atol=atol)
    torch.testing.assert_close(t, t_p, rtol=0, atol=atol)
    assert torch.isfinite(t).all()


def test_failed_solve_stays_nan_through_the_guard_on_card(cuda, monkeypatch):
    """On the card a damped system that is not positive definite solves to
    NaN, a positive definite one as on the CPU (within 1e-5 relative), and
    the baselines' guard lets the NaN through while it resets a sample
    with ``||t|| > 1`` to the identity."""
    from deep_prob_feature_track_torch.apps.baselines import ICPOdometry
    from deep_prob_feature_track_torch.ops import solver6

    g = torch.Generator().manual_seed(4)
    J = torch.randn(3, 50, 6, generator=g)
    H = torch.einsum("bpi,bpj->bij", J, J)
    H[1, 0, 1] = H[1, 1, 0] = 2.0 * torch.sqrt(H[1, 0, 0] * H[1, 1, 1])  # indefinite
    rhs = torch.randn(3, 6, generator=g)
    x = solver6.solve_chol(H.to(cuda), rhs.to(cuda)).cpu()
    x_cpu = solver6.solve_chol(H, rhs)
    assert torch.isnan(x[1]).all() and torch.isnan(x_cpu[1]).all()
    torch.testing.assert_close(x[[0, 2]], x_cpu[[0, 2]], rtol=1e-5, atol=1e-6)

    tracker = ICPOdometry()
    R = torch.eye(3, device=cuda).repeat(3, 1, 1) * 2
    t = torch.tensor([[0.0, 5.0, 0.0], [float("nan")] * 3, [0.3, 0.2, 0.1]], device=cuda)
    monkeypatch.setattr(tracker, "track", lambda *a: (R, t))
    depth = torch.ones(3, 1, 8, 8, device=cuda)
    R_out, t_out = tracker.batch_track(None, depth, None, depth, None)
    assert R_out.device.type == "cuda"
    torch.testing.assert_close(R_out[0], torch.eye(3, device=cuda), rtol=0, atol=0)
    assert torch.all(t_out[0] == 0) and torch.isnan(t_out[1]).all()
    torch.testing.assert_close(R_out[1:], R[1:], rtol=0, atol=0)
    torch.testing.assert_close(t_out[2], t[2], rtol=0, atol=0)


def test_compute_residual_on_card(cuda):
    """``compute_residual`` of ``feature`` at each level, B=8 120x160: one K1
    a call, within 1e-6 relative of the plain versions (K1 is bit-exact;
    no K6 runs)."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    batch = example_batch(8, 120, 160, seed=3, device=cuda)
    net = build_tracker("feature", device=cuda)
    plain = build_tracker("feature", device=cuda, plain_kernels=True)
    with torch.inference_mode():
        pose = net(*batch)
        for level in range(4):
            tk.reset_launches()
            _, cost = net.compute_residual(*batch, pose_init=pose, level=level)
            torch.cuda.synchronize()
            assert tk.LAUNCHES == _launches(gather_twohot=1)
            _, cost_p = plain.compute_residual(*batch, pose_init=pose, level=level)
            torch.testing.assert_close(cost, cost_p, rtol=1e-6, atol=0)
            assert torch.isfinite(cost).all() and (cost > 0).all()


# the tracker options: a learned ICP scale reads the first iteration's
# residuals and upsamples the prior weights at levels 2-0 (3 more K1); the
# other options launch as their preset
VARIANT_LAUNCHES = {
    ("feature_icp", ("scaler=MultiScale2w",)): {"gather_twohot": 27, "fused_jtj_jtr": 12},
    ("feature", ("init_pose_type=dense_net",)): {"gather_twohot": 12, "fused_jtj_jtr": 12},
    ("feature", ("multi_hypo=average",)): {"gather_twohot": 12, "fused_jtj_jtr": 12},
    ("feature", ("multi_hypo=None", "res_input=1")): {"gather_twohot": 12, "fused_jtj_jtr": 12},
    ("feature", ("encoder_name=ConvRGBD",)): {"gather_twohot": 12, "fused_jtj_jtr": 12},
    ("DeepIC", ("no_weight_sharing=1",)): {"gather_twohot": 51},
    ("RGB", ("init_pose_type=sfm_net",)): {"gather_twohot": 24},
}


@pytest.mark.parametrize("preset,overrides", sorted(VARIANT_LAUNCHES))
def test_variant_forward_kernels_match_plain_on_card(cuda, preset, overrides):
    """Each tracker option's forward at 120x160 B=8: kernels against plain
    within 1e-5 on R and t, the launch counts of ``VARIANT_LAUNCHES``."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker, example_batch

    batch = example_batch(8, 120, 160, seed=3, device=cuda)
    kern = build_tracker(preset, device=cuda, overrides=overrides)
    plain = build_tracker(preset, device=cuda, plain_kernels=True, overrides=overrides)
    tk.reset_launches()
    with torch.inference_mode():
        R, t = kern(*batch)
        assert tk.LAUNCHES == _launches(**VARIANT_LAUNCHES[(preset, overrides)])
        Rp, tp = plain(*batch)
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)
    assert np.isfinite(t.cpu().numpy()).all()


def _smooth_batch(cuda):
    from deep_prob_feature_track_torch.training import train as tt

    batch = tt.synthetic_batch(8, 120, 160, seed=2, device=cuda)
    return [batch[k] for k in ("color0", "color1", "depth0", "depth1", "calib")]


def test_exp_scale_forward_kernels_match_plain_on_card(cuda):
    """``feature_icp`` with ``scaler=expMultiScale`` on smooth scenes: it
    weighs the ICP term up to 400x ``MultiScale2w``'s, and on uniform-noise
    depth its flipped ICP masks move the pose ~1e-2 between two roundings
    of K6's sums; here within 1e-5, K1 27 and K6 12."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker

    batch = _smooth_batch(cuda)
    outs = []
    for plain in (False, True):
        net = build_tracker("feature_icp", device=cuda, plain_kernels=plain,
                            overrides=["scaler=expMultiScale"])
        tk.reset_launches()
        with torch.inference_mode():
            outs.append(net(*batch))
        if not plain:
            assert tk.LAUNCHES == _launches(gather_twohot=27, fused_jtj_jtr=12)
    (R, t), (Rp, tp) = outs
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)


def test_uncer_prop_forward_kernels_match_plain_on_card(cuda):
    """``feature`` with ``uncer_prop`` on smooth scenes: the pose within
    1e-5 and level 0's information matrix within 1e-4 of its largest entry,
    K1 12 and K6 12 (on uniform-noise images a flipped occlusion or
    sigma-extreme pixel moves the matrix by its own share)."""
    from deep_prob_feature_track_torch.apps.serve import build_tracker

    batch = _smooth_batch(cuda)
    outs = []
    for plain in (False, True):
        net = build_tracker("feature", device=cuda, plain_kernels=plain,
                            overrides=["uncer_prop=1"])
        tk.reset_launches()
        with torch.inference_mode():
            outs.append(net(*batch))
        if not plain:
            assert tk.LAUNCHES == _launches(gather_twohot=12, fused_jtj_jtr=12)
    ((R, t), info), ((Rp, tp), info_p) = outs
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)
    scale = info_p.abs().amax(dim=(1, 2), keepdim=True)
    assert ((info - info_p).abs() <= 1e-4 * scale).all()


@pytest.mark.parametrize("HW", [300, 19200])
def test_fused_jtj_backward_with_a_jtj_cotangent_on_card(cuda, HW):
    """``FusedJtJ`` with a nonzero JtJ cotangent (the uncertainty losses'
    path): its forward through K6 against the float64 plain version (rtol
    1e-5, 1e-5 of the largest entry), its backward bit for bit with the
    plain run's."""
    g = torch.Generator().manual_seed(HW)
    inputs = [torch.randn(*s, generator=g).to(cuda) for s in ((8, 8, HW),) * 3 + ((8, HW, 6),) * 2]
    G = torch.randn(8, 6, 6, generator=g)
    cot = [(G + G.transpose(1, 2)).to(cuda), torch.randn(8, 6, 1, generator=g).to(cuda)]

    def run(plain, dtype):
        xs = [a.to(dtype).clone().requires_grad_() for a in inputs]
        outs = tk.FusedJtJ.apply(*xs, -1.0, plain)
        torch.autograd.backward(outs, [c.to(dtype) for c in cot])
        return [o.detach() for o in outs] + [x.grad for x in xs]

    tk.reset_launches()
    got = run(False, torch.float32)
    assert tk.LAUNCHES == _launches(fused_jtj_jtr=1)
    plain = run(True, torch.float32)
    ref = [t.float() for t in run(True, torch.float64)]
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=1e-5, atol=1e-5 * r.abs().max().item())
    for x, r in zip(got[2:], plain[2:]):
        assert torch.equal(x, r)


@pytest.mark.parametrize("preset,overrides,loss,launches", [
    ("feature", ("uncer_prop=1",), "UEPE3D",
     dict(gather_twohot_grads=12, splat_twohot=12, fused_jtj_jtr=12)),
    ("feature", ("uncer_prop=1",), "URPE",
     dict(gather_twohot_grads=12, splat_twohot=12, fused_jtj_jtr=12)),
    ("feature_icp", ("scaler=MultiScale2w",), "EPE3D",
     dict(gather_twohot_grads=27, splat_twohot=15, fused_jtj_jtr=12)),
])
def test_variant_train_step_on_card(cuda, preset, overrides, loss, launches):
    """One loss and backward at 60x80 B=4 through the kernels and through
    their plain versions: the launch counts, the loss within 1e-5 relative,
    each gradient leaf within 5e-3 of its largest entry."""
    from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    batch = tt.synthetic_batch(4, 60, 80, seed=3, device=cuda)
    cfg = tt.TrainConfig(loss=loss)
    results = []
    for plain in (False, True):
        net = LeastSquareTracking(apply_overrides(get_preset(preset), overrides),
                                  plain_kernels=plain)
        state = tt.create_train_state(net, cfg, seed=1, device=cuda)
        tk.reset_launches()
        value = tt.compute_loss(state.net, cfg, batch)
        value.backward()
        torch.cuda.synchronize()
        if not plain:
            assert tk.LAUNCHES == _launches(**launches)
        results.append((value.item(), {k: p.grad for k, p in net.named_parameters()}))
    (value, grads), (value_p, grads_p) = results
    assert np.isfinite(value) and abs(value - value_p) <= 1e-5 * abs(value_p)
    for key, ref in grads_p.items():
        torch.testing.assert_close(grads[key], ref, rtol=0,
                                   atol=5e-3 * ref.abs().max().item(), msg=key)


def _plane_window(device, n=4, H=120, W=160, C=8, seed=0):
    """A textured plane 2 m ahead seen from ``n`` poses 0.02 rad / 5 cm
    apart (``C`` feature channels of sinusoids of the world point, sigma
    ``0.5 + feats^2``) and the poses perturbed by 0.01: ``(WindowFrames,
    R0, t0, edges_i, edges_j)`` for ``refine_dense_window``, edges spanning
    2 frames."""
    from deep_prob_feature_track_torch.geometry import lie as tl
    from deep_prob_feature_track_torch.parallel.dense_ba import WindowFrames

    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[0.8 * W, 0.8 * W, (W - 1) / 2.0, (H - 1) / 2.0]]).repeat(n, 1)
    steps = torch.cat([torch.rand(n - 1, 3, generator=g) * 0.04 - 0.02,
                       torch.rand(n - 1, 3, generator=g) * 0.1 - 0.05], dim=1)
    R, t = [torch.eye(3)], [torch.zeros(3)]
    for dR, dt in zip(*tl.exp_se3(steps)):
        R.append(R[-1] @ dR)
        t.append(R[-2] @ dt + t[-1])
    R, t = torch.stack(R), torch.stack(t)
    px, py = tw.generate_xy_grid(n, H, W, K)
    dirs = torch.cat([px, py, torch.ones_like(px)], dim=1)
    z = (2.0 - t[:, 2, None, None, None]) / torch.einsum("nj,njhw->nhw", R[:, 2], dirs)[:, None]
    X = torch.einsum("nij,njhw->nihw", R, dirs * z) + t[:, :, None, None]
    freqs = torch.rand(C, 2, generator=g) * 12 + 3
    feats = torch.sin(X[:, 0:1] * freqs[:, 0, None, None] + 1.0) * torch.cos(
        X[:, 1:2] * freqs[:, 1, None, None])
    frames = WindowFrames(feats, 0.5 + feats ** 2, 1.0 / z, K)
    dR, dt = tl.exp_se3(torch.randn(n - 1, 6, generator=g) * 0.01)
    R0 = torch.cat([R[:1], R[1:] @ dR])
    t0 = torch.cat([t[:1], torch.einsum("nij,nj->ni", R[1:], dt) + t[1:]])
    ei = torch.tensor([i for i in range(n) for j in range(i + 1, min(i + 3, n))])
    ej = torch.tensor([j for i in range(n) for j in range(i + 1, min(i + 3, n))])
    return (WindowFrames(*(x.to(device) for x in frames)), R0.to(device), t0.to(device),
            ei.to(device), ej.to(device))


@pytest.mark.parametrize("H,W", [(120, 160), (480, 640)])
def test_dense_window_kernels_match_plain_on_card(cuda, H, W):
    """``refine_dense_window`` through the kernels against their plain
    versions on the card: poses within 1e-5, costs within 1e-5 relative; a
    gather (K1, or K4 at 480x640: the C=10 operand takes the tile kernel
    there) and a K6 reduction per outer iteration; two calls give the same
    bits."""
    from deep_prob_feature_track_torch.parallel.dense_ba import refine_dense_window

    args = _plane_window(cuda, H=H, W=W)
    tk.reset_launches()
    R, t, costs = refine_dense_window(*args, iterations=3)
    gather = "gather_tiles" if H == 480 else "gather_twohot"
    assert tk.LAUNCHES == _launches(**{gather: 3, "fused_jtj_jtr": 3})
    Rp, tp, costs_p = refine_dense_window(*args, iterations=3, plain=True)
    torch.testing.assert_close(R, Rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)
    torch.testing.assert_close(costs, costs_p, rtol=1e-5, atol=0)
    assert float(costs[-1]) < float(costs[0])
    again = refine_dense_window(*args, iterations=3)
    assert all(torch.equal(a, b) for a, b in zip((R, t, costs), again))


def test_pose_graph_on_card(cuda):
    """``refine_pose_graph`` in float64 on the card against the CPU within
    1e-9, in float32 against float64 within 1e-5; two card calls give the
    same bits (the blocks are summed by a sorted ``index_put_``, not atomics)."""
    from deep_prob_feature_track_torch.geometry import lie as tl
    from deep_prob_feature_track_torch.parallel import ba

    g = torch.Generator().manual_seed(0)
    n = 12
    steps = torch.cat([torch.randn(n - 1, 3, generator=g, dtype=torch.float64) * 0.1,
                       torch.randn(n - 1, 3, generator=g, dtype=torch.float64) * 0.3], dim=1)
    poses = [np.eye(4)]
    for dR, dt in zip(*tl.exp_se3(steps)):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = dR.numpy(), dt.numpy()
        poses.append(poses[-1] @ T)
    poses = np.stack(poses)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, min(i + 4, n))]
    rel = [np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs]
    meas = [(T[:3, :3], T[:3, 3]) for T in rel]
    A = torch.randn(len(pairs), 6, 6, generator=g, dtype=torch.float64)
    infos = list((A @ A.transpose(1, 2) + torch.eye(6, dtype=torch.float64)).numpy())
    init = poses.copy()
    dR, dt = tl.exp_se3(torch.randn(n - 1, 6, generator=g, dtype=torch.float64) * 0.05)
    init[1:, :3, :3] = init[1:, :3, :3] @ dR.numpy()
    init[1:, :3, 3] += np.einsum("nij,nj->ni", poses[1:, :3, :3], dt.numpy())
    out = {}
    for device, dtype in ((cuda, torch.float64), ("cpu", torch.float64), (cuda, torch.float32)):
        graph = ba.build_window_graph(init, pairs, meas, infos, device=device, dtype=dtype)
        out[device, dtype] = ba.refine_pose_graph(graph, iterations=8)
        if device == cuda:
            again = ba.refine_pose_graph(graph, iterations=8)
            assert torch.equal(again[0].R, out[device, dtype][0].R)
            assert torch.equal(again[1], out[device, dtype][1])
    card, cpu, f32 = (out[k][0] for k in ((cuda, torch.float64), ("cpu", torch.float64),
                                          (cuda, torch.float32)))
    torch.testing.assert_close(card.R.cpu(), cpu.R, rtol=0, atol=1e-9)
    torch.testing.assert_close(card.t.cpu(), cpu.t, rtol=0, atol=1e-9)
    torch.testing.assert_close(f32.t.double(), card.t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(card.t.cpu().numpy(), poses[:, :3, 3], atol=1e-8)


def _accum_step_on_card(cuda, plain, accum=2):
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    cfg = tt.TrainConfig(accum_steps=accum)
    net = LeastSquareTracking(get_preset("feature"), plain_kernels=plain)
    state = tt.create_train_state(net, cfg, seed=1, device=cuda)
    tk.reset_launches()
    state, metrics = tt.make_train_step(cfg, 100)(state, tt.synthetic_batch(4, 60, 80, seed=3,
                                                                            device=cuda))
    torch.cuda.synchronize()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    return metrics, grads, dict(tk.LAUNCHES), {k: p.detach() for k, p in net.named_parameters()}


def test_accumulated_step_kernels_match_plain_on_card(cuda):
    """``accum_steps=2``: 12 launches of K2, K3 and K6 a microbatch; the
    loss within 1e-5 relative of the plain step's, the averaged gradients
    within 5e-3 of each leaf's largest entry, the parameters within 2 lr
    (one Adam update each)."""
    from deep_prob_feature_track_torch.training import train as tt

    (m, grads, launches, params), (m_p, grads_p, launches_p, params_p) = (
        _accum_step_on_card(cuda, plain) for plain in (False, True))
    assert launches == {**{k: 0 for k in launches}, "gather_twohot_grads": 24,
                        "splat_twohot": 24, "fused_jtj_jtr": 24}
    assert not any(launches_p.values())
    loss, loss_p = m["loss"].item(), m_p["loss"].item()
    assert np.isfinite(loss) and abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for key, ref in grads_p.items():
        torch.testing.assert_close(grads[key], ref, rtol=0,
                                   atol=5e-3 * ref.abs().max().item(), msg=key)
    lr = tt.TrainConfig().lr
    assert max((params[k] - params_p[k]).abs().max().item() for k in params) <= 2 * lr


def test_guard_skips_a_nan_batch_bit_for_bit_on_card(cuda):
    import copy

    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature")), cfg, seed=1,
                                  device=cuda)
    step = tt.make_train_step(cfg, 100, guard_nonfinite=True)
    state, metrics = step(state, tt.synthetic_batch(2, 60, 80, seed=1, device=cuda))
    assert not bool(metrics["skipped"])
    net_before = copy.deepcopy(state.net.state_dict())
    opt_before = copy.deepcopy(state.optimizer.state_dict()["state"])
    batch = tt.synthetic_batch(2, 60, 80, seed=2, device=cuda)
    batch["depth0"][0] = float("nan")
    state, metrics = step(state, batch)
    assert bool(metrics["skipped"]) and state.step == 2
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, net_before[k]), k
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k]), (i, k)


# ------------------------------------------------- the training memory modes


def _bf16_bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("coords", ["random", "smooth", "teleported"])
@pytest.mark.parametrize("C", [1, 3, 6, 10, 11, 28])
@pytest.mark.parametrize("offset", [False, True])
def test_gather_grads_bf16_mode_matches_its_twin(cuda, offset, C, coords):
    """K2's bf16 mode (``bf16_residuals``), compact and scattered runs,
    scalar and float2 loads: ``out`` its float32 launch's bits, gx/gy the
    bits of its plain twin (the float32 maps cast after) and of its own
    float32 maps cast."""
    B, H, W, N = FLAT_CASES[1]
    F = _plane(cuda, B, H, W, C, offset)
    args = _flat_coords(cuda, B, H, W, N, coords)
    n0 = tk.LAUNCHES["gather_twohot_grads"]
    out, gx, gy = tk.gather_twohot_grads(F, *args, True)
    assert tk.LAUNCHES["gather_twohot_grads"] == n0 + 1
    out32, gx32, gy32 = tk.gather_twohot_grads(F, *args)
    ref = tk.gather_twohot_grads_ref(F, *args, True)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and gx.dtype == gy.dtype == torch.bfloat16
    assert torch.equal(out, out32) and torch.equal(out, ref[0])
    for got, twin, f32 in ((gx, ref[1], gx32), (gy, ref[2], gy32)):
        assert torch.equal(_bf16_bits(got), _bf16_bits(twin))
        assert torch.equal(_bf16_bits(got), _bf16_bits(f32.to(torch.bfloat16)))


@pytest.mark.parametrize("coords", ["smooth", "global", "mixed"])
@pytest.mark.parametrize("C", [1, 3, 6, 10, 11, 28])
def test_gather_tiles_grads_bf16_mode_matches_its_twin(cuda, C, coords):
    """K5's bf16 mode at 640x480 level 1, staged and global tiles: as K2's."""
    B, H, W = 4, 240, 320
    F = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(C)).to(cuda)
    maps = _tile_maps(cuda, B, H, W, H, W, coords)
    n0 = tk.LAUNCHES["gather_tiles_grads"]
    out, gx, gy = tk.gather_tiles_grads(F, *maps, True)
    assert tk.LAUNCHES["gather_tiles_grads"] == n0 + 1
    out32, gx32, gy32 = tk.gather_tiles_grads(F, *maps)
    ref = tk.gather_tiles_grads_ref(F, *maps, True)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and gx.dtype == gy.dtype == torch.bfloat16
    assert torch.equal(out, out32) and torch.equal(out, ref[0])
    for got, twin, f32 in ((gx, ref[1], gx32), (gy, ref[2], gy32)):
        assert torch.equal(_bf16_bits(got), _bf16_bits(twin))
        assert torch.equal(_bf16_bits(got), _bf16_bits(f32.to(torch.bfloat16)))


def _modes_step(cuda, modes, B, H, W):
    """One ``feature`` step on the card with the tracker's training
    ``modes``: every gradient, parameter, buffer and Adam moment after it,
    the loss, and the launches."""
    from deep_prob_feature_track_torch.models.presets import get_preset
    from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
    from deep_prob_feature_track_torch.training import train as tt

    cfg = tt.TrainConfig()
    state = tt.create_train_state(LeastSquareTracking(get_preset("feature"), **modes), cfg,
                                  seed=1, device=cuda)
    step = tt.make_train_step(cfg, 100, guard_nonfinite=True)
    tk.reset_launches()
    state, metrics = step(state, tt.synthetic_batch(B, H, W, seed=3, device=cuda))
    torch.cuda.synchronize()
    out = {f"metric {k}": v.detach().clone() for k, v in metrics.items()}
    out.update({f"grad {k}": p.grad.clone() for k, p in state.net.named_parameters()})
    out.update({f"state {k}": v.clone() for k, v in state.net.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam {i} {k}": v.clone() for k, v in st.items()})
    return out, dict(tk.LAUNCHES)


# unrolled launches a step: at 60x80 K2 12 / K3 12 / K6 12; at 96x448 level
# 0 takes K5 (3) and the others K2 (9)
MODES_STEPS = {(60, 80): _launches(gather_twohot_grads=12, splat_twohot=12, fused_jtj_jtr=12),
               (96, 448): _launches(gather_twohot_grads=9, gather_tiles_grads=3, splat_twohot=12,
                                    fused_jtj_jtr=12)}


@pytest.mark.parametrize("encoder", [False, True])
@pytest.mark.parametrize("H,W", sorted(MODES_STEPS))
def test_rematted_step_equals_unrolled_step_bit_for_bit_on_card(cuda, H, W, encoder):
    """``remat_gn`` (and ``remat_encoder``) through the kernels: the step's
    bits are the unrolled step's (loss, gradients, parameters, BatchNorm
    statistics, Adam moments, ``skipped``); the replays launch K2/K5 and K6
    once more an iteration, K3 as often as without them."""
    ref, launches = _modes_step(cuda, {}, 4, H, W)
    assert launches == MODES_STEPS[(H, W)]
    got, launches = _modes_step(cuda, {"remat_gn": True, "remat_encoder": encoder}, 4, H, W)
    assert launches == {k: n * (1 if k == "splat_twohot" else 2) for k, n in
                        MODES_STEPS[(H, W)].items()}
    assert got.keys() == ref.keys()
    differ = [k for k, v in ref.items() if not torch.equal(got[k], v)]
    assert not differ, differ


def test_bf16_step_against_the_float32_step_on_card(cuda):
    """``bf16_residuals`` through K2/K5's bf16 mode at 96x448: the same
    launches and the same loss (the maps reach only the backward), each
    gradient leaf within 5e-3 of the float32 step's largest entry."""
    ref, launches = _modes_step(cuda, {}, 4, 96, 448)
    got, launches_bf16 = _modes_step(cuda, {"bf16_residuals": True}, 4, 96, 448)
    assert launches_bf16 == launches
    assert torch.equal(got["metric loss"], ref["metric loss"])
    for key in (k for k in ref if k.startswith("grad ")):
        torch.testing.assert_close(got[key], ref[key], rtol=0,
                                   atol=5e-3 * ref[key].abs().max().item(), msg=key)
