"""PyTorch port vs the JAX package: what the ``DeepIC`` preset adds around
its modules.  The align-corners resize of its M-estimator's prior
(``bilinear_resize_align``, both routes) within atol 1e-6; the damping
samples of its ``Direct-ResVol`` solve equal to the jitted ``jnp.logspace``
bit for bit; and its damping MLP's seeded init, which draws every weight
from the seed whatever the global RNG's state.  The modules and the level
solve are held in ``tests/test_torch_port_deepic.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.models.presets import get_preset
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking
from deep_prob_feature_track_torch.ops.image import bilinear_resize_align
from deep_prob_feature_track_torch.solvers import trust_region as ttr
from deep_prob_feature_track_tpu.ops import image as jimage

torch.set_num_threads(2)

B = 2
S = 10  # the preset's damping samples


@pytest.mark.parametrize("size", [(15, 20, 30, 40), (8, 10, 32, 40), (4, 5, 7, 9)])
def test_bilinear_resize_align_matches_jax(size):
    h, w, Ho, Wo = size
    x = np.random.RandomState(h).rand(B, 1, h, w).astype(np.float32)
    ref = np.asarray(jimage.bilinear_resize_align(jnp.asarray(x), Ho, Wo))
    for plain in (False, True):
        got = bilinear_resize_align(torch.from_numpy(x), Ho, Wo, plain=plain)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    xt = torch.from_numpy(x)
    assert bilinear_resize_align(xt, h, w) is xt  # no resize, no gather


@pytest.mark.parametrize("samples", [10, 2, 7, 16])
def test_damping_samples_equal_jax(samples):
    """The jitted ``jnp.logspace`` of the JAX solve, bit for bit (the eager
    one differs in the last bit of some samples; ``torch.logspace`` by up
    to 4.4e-7 relative)."""
    ref = np.asarray(jax.jit(lambda: jnp.logspace(-5.0, 5.0, samples, dtype=jnp.float32))())
    got = ttr._lambdas(samples, torch.float32, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_seeded_init_draws_every_weight_from_the_seed():
    """The damping MLP's linears take flax ``Dense``'s init (lecun-normal
    kernel truncated at 2 std, zero bias) from the seed, whatever the
    global RNG's state."""
    torch.manual_seed(0)
    a = LeastSquareTracking(get_preset("DeepIC")).reset_parameters(5).state_dict()
    torch.manual_seed(1)
    b = LeastSquareTracking(get_preset("DeepIC")).reset_parameters(5).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for i, fan_in in enumerate((6 * S + 36, 128, 256)):
        w = a[f"solver_func.net.{i}.0.weight"]
        std = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
        assert w.abs().max() <= 2 * std and w.std() > 0.5 * std
        assert torch.equal(a[f"solver_func.net.{i}.0.bias"], torch.zeros(w.shape[0]))
