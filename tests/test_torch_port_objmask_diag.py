"""PyTorch port vs the JAX package: ``compute_residual`` and
``track_diagnostics`` with object masks.

The inputs, masks and weights of ``tests/test_torch_port_objmask_track.py``
(golden inputs, B=2, 32x40; U_FC at 64x80).  ``compute_residual`` starts
from a non-identity pose at levels 0 and 2; the masks reach the U_IC and IC
residuals, while the U_FC and ICP residuals and the fused ICP term take
none, in both packages.  ``track_diagnostics`` runs one track of each type:
U_IC (``feature``), IC (``RGB``), U_FC and ICP, and every entry of its
``diag`` is compared at every level.

Tolerances: residuals atol 1e-5 with rtol 1e-5; the diagnostics' features,
sigma and residual maps and poses atol 1e-5 with rtol 1e-5, the match
coordinates within 1e-4 pixel, the invalid masks and the matches' validity
bit for bit.  Where the two poses land further apart the maps follow them
by the pose gap times the noise images' gradients: ``RGB``'s residual maps
atol 2e-4 (poses 1e-6 apart, a gray gradient of order 10 a pixel at fx 26);
``ICP``'s poses atol 1e-4 (1.1e-5 apart, the bound of
``tests/test_torch_port_presets.py``), its depth maps 1e-3 (the noise
depth's gradients reach 2.5 m a pixel), matches 1e-3 pixel; U_FC's, after
12 forward-warp solves, poses atol 1e-4, maps 1e-3 (a residual map divides
by sigma), matches 1e-2 pixel.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_objmask_track import UFC, golden_inputs, trackers  # noqa: E402

torch.set_num_threads(2)

RESIDUAL_CASES = {"feature": ("feature", ()), "feature_icp": ("feature_icp", ()),
                  "RGB": ("RGB", ()), "U_FC": ("feature", UFC), "ICP": ("ICP", ())}
# per track type: preset, overrides, size, pose atol, map atol, match atol
DIAG_CASES = {"U_IC": ("feature", (), (32, 40), 1e-5, 1e-5, 1e-4),
              "IC": ("RGB", (), (32, 40), 1e-5, 2e-4, 1e-4),
              "U_FC": ("feature", UFC, (64, 80), 1e-4, 1e-3, 1e-2),
              "ICP": ("ICP", (), (32, 40), 1e-4, 1e-3, 1e-3)}


def _pose(b):
    rng = np.random.RandomState(11)
    from deep_prob_feature_track_tpu.geometry import lie as jl

    R = np.asarray(jl.exp_so3(jnp.asarray(rng.randn(b, 3) * 0.02, jnp.float32)))
    return R, (rng.randn(b, 3) * 0.02).astype(np.float32)


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_compute_residual_with_masks(case):
    preset, overrides = RESIDUAL_CASES[case]
    ins, (m0, m1) = golden_inputs()
    port, net, v = trackers(preset, overrides)
    R, t = _pose(2)
    for level in (0, 2):
        _, ref = jax.jit(lambda *a: net.apply(
            v, *a[:5], pose_init=(a[5], a[6]), level=level, obj_mask0=a[7], obj_mask1=a[8],
            method="compute_residual"))(*map(jnp.asarray, (*ins, R, t, m0, m1)))
        with torch.inference_mode():
            _, got = port.compute_residual(
                *map(torch.from_numpy, ins), pose_init=(torch.from_numpy(R), torch.from_numpy(t)),
                level=level, obj_mask0=torch.from_numpy(m0), obj_mask1=torch.from_numpy(m1))
            _, plain = port.compute_residual(
                *map(torch.from_numpy, ins), pose_init=(torch.from_numpy(R), torch.from_numpy(t)),
                level=level)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        if case in ("U_FC", "ICP"):  # these residuals take no mask
            torch.testing.assert_close(got, plain, rtol=0, atol=0)
        else:
            assert (got - plain).abs().max() > 1e-4


@pytest.mark.parametrize("track", list(DIAG_CASES))
def test_track_diagnostics_with_masks(track):
    preset, overrides, (h, w), pose_tol, map_tol, match_tol = DIAG_CASES[track]
    ins, (m0, m1) = golden_inputs(h, w)
    port, net, v = trackers(preset, overrides)
    assert port.cfg.track_type == track
    (Rj, tj), ref = jax.jit(lambda *a: net.apply(
        v, *a[:5], obj_mask0=a[5], obj_mask1=a[6], method="track_diagnostics"))(
        *map(jnp.asarray, (*ins, m0, m1)))
    with torch.inference_mode():
        (R, t), got = port.track_diagnostics(*map(torch.from_numpy, ins),
                                             obj_mask0=torch.from_numpy(m0),
                                             obj_mask1=torch.from_numpy(m1))
        R_fwd, _ = port(*map(torch.from_numpy, ins), obj_mask0=torch.from_numpy(m0),
                        obj_mask1=torch.from_numpy(m1))
    torch.testing.assert_close(R, R_fwd, rtol=0, atol=0)  # the forward's pose
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=pose_tol, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=pose_tol, rtol=0)
    assert set(got) == set(ref)
    for key in ref:
        for level in range(4):
            g, r = got[key][level], ref[key][level]
            if key == "poses":
                for a, b in zip(g, r):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=pose_tol, rtol=0)
            elif key == "matches":
                np.testing.assert_allclose(g[0].numpy(), np.asarray(r[0]), atol=match_tol,
                                           rtol=0)
                np.testing.assert_array_equal(g[1].numpy(), np.asarray(r[1]))
            elif key == "invalid":
                np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f"{level}")
            else:
                assert g.shape == r.shape, (key, level)
                np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=map_tol, rtol=1e-5,
                                           err_msg=f"{key} level {level}")
    B, C = ins[0].shape[0], got["features0"][0].shape[1]
    assert got["sigma0"][0].shape[1] == C  # re-broadcast past the sigma-slim
    assert got["matches"][0][0].shape == (B, 2, 64)  # a grid of 8 x 8
    if track in ("U_IC", "IC"):  # the object masks reach the residual's invalid mask
        assert got["invalid"][0][torch.from_numpy(~m0)].all()
