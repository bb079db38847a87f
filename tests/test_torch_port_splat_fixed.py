"""K3's plain version in fixed point, on the CPU (no card, no JAX).

For float32, ``ops/kernels/splat.py::splat_twohot_ref`` rounds each
product ``g * w`` to an int64 multiple of ``2**-s`` of its (b, c) channel
and sums the integers, as the CUDA kernel does, so that the sum's bits do
not depend on the order of the adds.  Held here:

- against a float64 ``index_add_`` of the same float32 products: within
  ``N * 2**-s / 2`` (one half quantum a product) plus one float32 rounding
  of the result, at 32x40, 120x160, a 2x2 plane that every sample hits and
  N = 307,200 (480x640);
- permuting the samples along N gives the same bits; on the 2x2 plane the
  same permutation moves a float32 ``index_add_`` sum of the same products;
- NaN and +-Inf in g, ``0 * Inf``, and NaN coordinates through
  ``geometry/warp.py::_corner_weights`` land where the float32 sum puts
  them; an all-zero g, subnormal values, and values near the float32
  maximum (Inf where the float64 sum overflows float32);
- float64 inputs give today's float64 ``index_add_`` sum bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry.warp import _corner_weights
from deep_prob_feature_track_torch.ops.kernels import splat, splat_twohot, splat_twohot_ref

torch.set_num_threads(2)


def _inputs(B, H, W, C, N, seed):
    """A seeded cotangent g [B,C,N] and the corner starts and weights of N
    samples uniform over (and 1 pixel past) an H x W plane."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(-1, W, (B, 1, N)).astype(np.float32)
    v = rng.uniform(-1, H, (B, 1, N)).astype(np.float32)
    g = rng.randn(B, C, N).astype(np.float32)
    args = _corner_weights((B, H, W, C), torch.from_numpy(u), torch.from_numpy(v))
    return torch.from_numpy(g), list(args)


def _corner_sum(g, v0, dv, u0, du, H, W, dtype):
    """The four corners' float32 products ``g * w``, summed by one
    ``index_add_`` a corner in ``dtype`` [B,H,W,C]: the sum the fixed
    point stands in for (float64) or the float32 sum it replaces."""
    B, C, N = g.shape
    idx = v0.long().clamp(0, H - 2) * W + u0.long().clamp(0, W - 2)
    idx = (idx + torch.arange(B)[:, None] * (H * W)).reshape(-1)
    g_nc = g.transpose(1, 2).reshape(B * N, C)
    du, dv = du.reshape(B * N, 1), dv.reshape(B * N, 1)
    out = torch.zeros((B * H * W, C), dtype=dtype)
    for offset, w in ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)), (W, (1 - du) * dv),
                      (W + 1, du * dv)):
        out.index_add_(0, idx + offset, (g_nc * w).to(dtype))
    return out.reshape(B, H, W, C)


def _assert_within_bound(got, g, args, H, W):
    """``got`` within ``N * 2**-s / 2`` of the float64 sum of the float32
    products, plus one float32 rounding of that sum, per (b, c)."""
    N = g.shape[2]
    exact = _corner_sum(g, *args, H, W, torch.float64)
    quantum = 2.0 ** -splat.fixed_point_shift(g).double()
    bound = N * quantum[:, None, None, :] / 2 + 2.0 ** -24 * exact.abs()
    gap = (got.double() - exact).abs()
    assert torch.isfinite(got).all()
    assert (gap <= bound).all(), (gap - bound).max().item()
    return gap, exact


@pytest.mark.parametrize("B,H,W,C,N", [(2, 32, 40, 10, 32 * 40), (2, 120, 160, 3, 120 * 160),
                                       (3, 2, 2, 5, 300)])
def test_fixed_point_sum_within_its_bound(B, H, W, C, N):
    g, args = _inputs(B, H, W, C, N, seed=H + C)
    got = splat_twohot_ref(g, *args, H, W)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, C)
    gap, exact = _assert_within_bound(got, g, args, H, W)
    # the fixed point is far finer than float32: never further from the
    # float64 sum than the float32 index_add_ sum is, by more than a rounding
    f32 = _corner_sum(g, *args, H, W, torch.float32)
    assert (gap <= (f32.double() - exact).abs() + 2.0 ** -23 * exact.abs()).all()
    # and the entry takes the plain version on the CPU
    assert torch.equal(splat_twohot(g, *args, H, W), got)


def test_fixed_point_sum_at_480x640():
    """N = 307,200: ceil(log2 N) = 19 bits of headroom, a quantum of 2**-42
    of the largest |g|."""
    H, W, C = 480, 640, 2
    g, args = _inputs(1, H, W, C, H * W, seed=7)
    s = splat.fixed_point_shift(g)
    top = g.abs().amax(dim=2)
    assert (s == 62 - 19 - torch.frexp(top).exponent).all()
    _assert_within_bound(splat_twohot_ref(g, *args, H, W), g, args, H, W)


@pytest.mark.parametrize("B,H,W,C,N", [(2, 32, 40, 10, 32 * 40), (2, 2, 2, 3, 300)])
def test_permuting_the_samples_keeps_the_bits(B, H, W, C, N):
    g, args = _inputs(B, H, W, C, N, seed=N)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(N))
    g_p = g[:, :, perm].contiguous()
    args_p = [a[:, perm].contiguous() for a in args]
    got = splat_twohot_ref(g, *args, H, W)
    assert torch.equal(splat_twohot_ref(g_p, *args_p, H, W), got)
    if H * W == 4:  # 300 samples a cell: the float32 sum's bits move
        f32 = _corner_sum(g, *args, H, W, torch.float32)
        f32_p = _corner_sum(g_p, *args_p, H, W, torch.float32)
        assert not torch.equal(f32, f32_p)


def _same_class(got, ref):
    for test in (torch.isnan, torch.isposinf, torch.isneginf, torch.isfinite):
        assert torch.equal(test(got), test(ref)), test.__name__


def test_non_finite_values_land_where_the_float_sum_puts_them():
    B, H, W, C, N = 2, 8, 10, 4, 80
    g, args = _inputs(B, H, W, C, N, seed=3)
    g[0, 0, 5] = float("nan")
    g[0, 1, 7] = float("inf")
    g[1, 2, 9] = -float("inf")
    g[1, 3, 11] = float("inf")
    g[1, 3, 12] = -float("inf")
    # an integer coordinate: its weights hold 0, so Inf * 0 = NaN there
    u = torch.rand(B, 1, N, generator=torch.Generator().manual_seed(4)) * (W - 1)
    v = torch.rand(B, 1, N, generator=torch.Generator().manual_seed(5)) * (H - 1)
    u[0, 0, 7], v[0, 0, 7] = 3.0, 2.5
    u[1, 0, 20] = float("nan")  # a NaN coordinate: NaN weights
    args = list(_corner_weights((B, H, W, C), u, v))
    got = splat_twohot_ref(g, *args, H, W)
    ref = _corner_sum(g, *args, H, W, torch.float32)
    _same_class(got, ref)
    assert torch.isnan(got).any() and torch.isposinf(got).any() and torch.isneginf(got).any()
    ok = torch.isfinite(ref)
    exact = _corner_sum(g, *args, H, W, torch.float64)
    torch.testing.assert_close(got[ok].double(), exact[ok], rtol=2.0 ** -23, atol=1e-12)


def test_all_zero_and_subnormal_cotangents():
    B, H, W, C, N = 2, 6, 7, 3, 42
    g, args = _inputs(B, H, W, C, N, seed=6)
    zero = splat_twohot_ref(torch.zeros_like(g), *args, H, W)
    assert torch.equal(zero, torch.zeros_like(zero)) and not torch.signbit(zero).any()
    tiny = g * 1e-39  # float32 subnormals, and their products
    assert (tiny[tiny != 0].abs() < 1.2e-38).all()
    s = splat.fixed_point_shift(tiny)
    # N = 42: ceil(log2 N) = 6 leaves more than 51 bits, so s = 51 - e
    assert s.tolist() == [[51 - math.frexp(float(tiny[b, c].abs().max()))[1]
                           for c in range(C)] for b in range(B)]
    _assert_within_bound(splat_twohot_ref(tiny, *args, H, W), tiny, args, H, W)


def test_values_near_the_float32_maximum():
    B, H, W, C, N = 1, 2, 2, 2, 16
    g, args = _inputs(B, H, W, C, N, seed=8)
    g[:, 0] = g[:, 0].abs().clamp(max=1.0) * 3e38  # one sign: sums past the float32 maximum
    g[:, 1] = g[:, 1] * 1e37
    got = splat_twohot_ref(g, *args, H, W)
    exact = _corner_sum(g, *args, H, W, torch.float64)
    over = exact.abs() > torch.finfo(torch.float32).max
    assert over[..., 0].any() and not over[..., 1].any()
    assert torch.equal(torch.isposinf(got), over)
    assert torch.equal(got[over], exact.float()[over])
    torch.testing.assert_close(got[~over].double(), exact[~over], rtol=2.0 ** -23, atol=0)
    _assert_within_bound(got[..., 1:], g[:, 1:].contiguous(), args, H, W)


def test_rounder_rounds_half_to_even():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-2.0 ** 51, 2.0 ** 51, 1000), rng.randint(-99, 99, 200) + 0.5,
                        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 2.0 ** 51 - 0.5, -(2.0 ** 51) + 0.5]])
    t = torch.from_numpy(x)
    assert torch.equal((t + splat.ROUNDER) - splat.ROUNDER, torch.from_numpy(np.rint(x)))


def test_float64_sum_is_todays_index_add():
    B, H, W, C, N = 2, 9, 11, 4, 99
    g, args = _inputs(B, H, W, C, N, seed=9)
    g, dv, du = g.double(), args[1].double(), args[3].double()
    idx = args[0].long().clamp(0, H - 2) * W + args[2].long().clamp(0, W - 2)
    idx = (idx + torch.arange(B)[:, None] * (H * W)).reshape(-1)
    g_nc = g.transpose(1, 2).reshape(B * N, C)
    du_, dv_ = du.reshape(B * N, 1), dv.reshape(B * N, 1)
    ref = torch.zeros((B * H * W, C), dtype=torch.float64)
    for offset, w in ((0, (1 - du_) * (1 - dv_)), (1, du_ * (1 - dv_)), (W, (1 - du_) * dv_),
                      (W + 1, du_ * dv_)):
        ref.index_add_(0, idx + offset, g_nc * w)
    got = splat_twohot_ref(g, args[0], dv, args[2], du, H, W)
    assert got.dtype == torch.float64
    assert torch.equal(got, ref.reshape(B, H, W, C))
