"""PyTorch port vs the JAX package: the masked forward of every preset.

The golden inputs of ``tests/test_golden.py`` (B=2, 32x40, seed 42; U_FC at
64x80, where its float32 solve is not chaotic: the watch list) with the
object masks of ``tests/test_torch_port_objmask.py`` (an ellipse in frame
0, a shifted, narrower one in frame 1, edges inside the frame).  The
weights are the port's seeded init (seed 7) carried to flax by the JAX
package's ``convert_state_dict``.  The identity-start presets (``RGB``,
``ICP``, ``RGB+ICP``, ``DeepIC``) are held to the same bound: no mask pixel
flips at an edge on these inputs.

Tolerances: R and t atol 1e-5; U_FC 1e-4 (its 12 forward-warp solves on
noise images land 2.4e-5 apart in float32) and the classical presets 1e-4,
the bound of ``tests/test_torch_port_presets.py`` (``ICP`` on the noise
depth lands 1.1e-5 apart).  The masks must move each pose
(but ICP's, which ignores them) by more than the tolerance.  Launches a
forward, counted at the kernel wrappers: as unmasked where the mask rides
in the operand (U_IC, U_FC) or is ignored (ICP); ``RGB`` 36 K1 for 24 and
``DeepIC`` 75 for 51, since the IC residual warps the frame-1 mask in a
gather of its own.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.geometry import warp as tw
from deep_prob_feature_track_torch.models.presets import apply_overrides, get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_tpu.models import presets as jp
from deep_prob_feature_track_tpu.models.import_torch import convert_state_dict
from deep_prob_feature_track_tpu.models.tracker import LeastSquareTracking as JaxTracker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_objmask import object_masks  # noqa: E402

torch.set_num_threads(2)

UFC = ("direction=forward",)
# preset, overrides, size, tolerance, K1 (K4) launches a forward unmasked
# and masked
CASES = {
    "feature": ("feature", (), (32, 40), 1e-5, 12, 12),
    "feature_icp": ("feature_icp", (), (32, 40), 1e-5, 24, 24),
    "DeepIC": ("DeepIC", (), (32, 40), 1e-5, 51, 75),
    "U_FC": ("feature", UFC, (64, 80), 1e-4, 12, 12),
    "RGB": ("RGB", (), (32, 40), 1e-4, 24, 36),
    "ICP": ("ICP", (), (32, 40), 1e-4, 12, 12),
    "RGB+ICP": ("RGB+ICP", (), (32, 40), 1e-4, 24, 24),
}


def golden_inputs(h=32, w=40, b=2):
    """The golden inputs at h x w (``tests/test_golden.py`` at 32x40) and
    the object masks."""
    rng = np.random.RandomState(42)
    ins = (rng.rand(b, 3, h, w).astype(np.float32),
           rng.rand(b, 3, h, w).astype(np.float32),
           rng.uniform(0.5, 3.0, (b, 1, h, w)).astype(np.float32),
           rng.uniform(0.5, 3.0, (b, 1, h, w)).astype(np.float32),
           np.tile([[26.0 * w / 40, 26.0 * h / 32, (w - 1) / 2, (h - 1) / 2]],
                   (b, 1)).astype(np.float32))
    return ins, object_masks(b, h, w)


def trackers(preset, overrides=()):
    """The port's seeded tracker (eval) and the JAX tracker with its
    variables."""
    port = LeastSquareTracking(apply_overrides(get_preset(preset), list(overrides)))
    port.reset_parameters(7)
    v = convert_state_dict(port.state_dict())
    assert v.pop("unmapped") == {}
    net = JaxTracker(cfg=jp.apply_overrides(jp.get_preset(preset), list(overrides)))
    return port, net, v


def count_gathers(monkeypatch):
    calls = {}
    for name in ("gather_twohot", "gather_tiles"):
        def call(*a, _fn=getattr(tw, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(tw, name, call)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_masked_forward_matches_jax(case, monkeypatch):
    preset, overrides, (h, w), tol, n_plain, n_masked = CASES[case]
    ins, (m0, m1) = golden_inputs(h, w)
    port, net, v = trackers(preset, overrides)
    fwd = jax.jit(lambda *a: net.apply(v, *a[:5], obj_mask0=a[5], obj_mask1=a[6], train=False))
    Rj, tj = (np.asarray(x) for x in fwd(*map(jnp.asarray, ins), jnp.asarray(m0),
                                         jnp.asarray(m1)))
    calls = count_gathers(monkeypatch)
    with torch.inference_mode():
        R, t = port(*map(torch.from_numpy, ins), obj_mask0=torch.from_numpy(m0),
                    obj_mask1=torch.from_numpy(m1))
        masked = sum(calls.values())
        calls.clear()
        R_u, t_u = port(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(R.numpy(), Rj, atol=tol, rtol=0)
    np.testing.assert_allclose(t.numpy(), tj, atol=tol, rtol=0)
    assert (masked, sum(calls.values())) == (n_masked, n_plain)
    moved = np.abs(t.numpy() - t_u.numpy()).max()
    if preset == "ICP":  # the stand-alone ICP track ignores the masks
        assert moved == 0.0
    else:
        assert moved > 10 * tol, moved


def test_masked_forward_of_a_partial_mask_pair():
    """Only ``obj_mask1``: the frame-1 mask alone reaches the U_IC operand;
    the pose is neither the unmasked nor the fully masked one."""
    ins, (m0, m1) = golden_inputs()
    port, net, v = trackers("feature")
    fwd = jax.jit(lambda *a: net.apply(v, *a[:5], obj_mask1=a[5], train=False))
    Rj, tj = (np.asarray(x) for x in fwd(*map(jnp.asarray, ins), jnp.asarray(m1)))
    with torch.inference_mode():
        R, t = port(*map(torch.from_numpy, ins), obj_mask1=torch.from_numpy(m1))
        _, t_both = port(*map(torch.from_numpy, ins), obj_mask0=torch.from_numpy(m0),
                         obj_mask1=torch.from_numpy(m1))
    np.testing.assert_allclose(R.numpy(), Rj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.numpy(), tj, atol=1e-5, rtol=0)
    assert np.abs(t.numpy() - t_both.numpy()).max() > 1e-4
