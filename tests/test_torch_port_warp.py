"""PyTorch port vs the JAX package: pixel grid, inverse-depth warp, the
stacked-operand bilinear warp and the occlusion test.

Coordinates include out-of-frame values and values exactly on the border
and on cell edges.  Tolerances (f32): the grid and the occlusion mask are
exact; warped pixel coordinates atol 1e-5 (they reach ~40, where one ulp
is 3.8e-6); warped maps atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_tpu.geometry import lie as jl
from deep_prob_feature_track_tpu.geometry import warp as jw

torch.set_num_threads(2)

B, H, W = 2, 24, 32
K = np.tile([[26.0, 25.0, 15.5, 11.5]], (B, 1)).astype(np.float32)


def _pose(rng, rot=0.05, trs=0.1):
    R = np.array(jl.exp_so3(jnp.asarray((rng.randn(B, 3) * rot).astype(np.float32))))
    return R, (rng.randn(B, 3) * trs).astype(np.float32)


def _uv(rng, h, w):
    u = rng.uniform(-4, W + 3, (B, 1, h, w)).astype(np.float32)
    v = rng.uniform(-4, H + 3, (B, 1, h, w)).astype(np.float32)
    edge_u = [0.0, W - 1.0, W, W - 2.0, -0.0, 7.0, W - 1.5]
    edge_v = [H - 1.0, 0.0, H, 3.0, H - 2.0, 0.0, 0.5]
    u[:, 0, 0, :7] = edge_u
    v[:, 0, 0, :7] = edge_v
    return u, v


def test_generate_xy_grid():
    px, py = tw.generate_xy_grid(B, H, W, torch.from_numpy(K))
    jx, jy = jw.generate_xy_grid(B, H, W, jnp.asarray(K))
    assert px.shape == (B, 1, H, W)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


@pytest.mark.parametrize("rot,trs", [(0.05, 0.1), (0.3, 0.5)])
def test_batch_warp_inverse_depth(rng, rot, trs):
    R, t = _pose(rng, rot, trs)
    invD = rng.uniform(0.3, 2.0, (B, 1, H, W)).astype(np.float32)
    px, py = jw.generate_xy_grid(B, H, W, jnp.asarray(K))
    ref = jw.batch_warp_inverse_depth(px, py, jnp.asarray(invD), (jnp.asarray(R), jnp.asarray(t)),
                                      jnp.asarray(K))
    tx, ty = tw.generate_xy_grid(B, H, W, torch.from_numpy(K))
    got = tw.batch_warp_inverse_depth(tx, ty, torch.from_numpy(invD),
                                      (torch.from_numpy(R), torch.from_numpy(t)),
                                      torch.from_numpy(K))
    for g, r, atol in zip(got, ref, (1e-5, 1e-5, 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("h,w", [(H, W), (7, 9)])
def test_warp_operand(rng, h, w):
    maps = [rng.randn(B, c, H, W).astype(np.float32) for c in (1, 8, 1)]
    u, v = _uv(rng, h, w)
    op_j, sizes_j = jw.make_warp_operand([jnp.asarray(m) for m in maps])
    ref = jw.warp_operand(op_j, sizes_j, jnp.asarray(u), jnp.asarray(v))
    op_t, sizes_t = tw.make_warp_operand([torch.from_numpy(m) for m in maps])
    assert sizes_t == sizes_j and op_t.is_contiguous()
    np.testing.assert_array_equal(op_t.numpy(), np.asarray(op_j))
    for plain in (False, True):
        got = tw.warp_operand(op_t, sizes_t, torch.from_numpy(u), torch.from_numpy(v),
                              plain=plain)
        assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_warp_operand_rejects_degenerate_plane(rng):
    """A plane under 2x2 is sampled in tensor ops, as the JAX package
    samples it away from its kernels (``tests/test_torch_port_lie.py``);
    the kernels' wrappers refuse it."""
    op = torch.from_numpy(rng.randn(B, 1, W, 3).astype(np.float32))
    u = torch.full((B, 1, 2, 2), 2.5)
    out = tw.warp_operand(op, [3], u, torch.zeros_like(u))[0]
    torch.testing.assert_close(out[..., 0, 0], 0.5 * (op[:, 0, 2] + op[:, 0, 3]))
    with pytest.raises(ValueError, match="2x2"):
        tw.gather_twohot(op, *tw._corner_weights(op.shape, u, u))


def test_check_occ_prewarped(rng):
    u, v = _uv(rng, H, W)
    inv_z = rng.uniform(0.2, 2.0, (B, 1, H, W)).astype(np.float32)
    inv_w = (inv_z + rng.uniform(-0.3, 0.3, inv_z.shape)).astype(np.float32)
    inv_w[:, 0, 1, :4] = inv_z[:, 0, 1, :4] + np.float32(0.1)  # on the threshold
    ref = jw.check_occ_prewarped(*map(jnp.asarray, (inv_z, inv_w, u, v)))
    got = tw.check_occ_prewarped(*map(torch.from_numpy, (inv_z, inv_w, u, v)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < got.numel()


def test_scale_K():
    for level in range(4):
        np.testing.assert_array_equal(tw.scale_K(torch.from_numpy(K), level).numpy(),
                                      np.asarray(jw.scale_K(jnp.asarray(K), level)))
