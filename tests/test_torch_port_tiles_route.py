"""PyTorch port vs the JAX package: the tile route.  ``use_tiles`` equals
the JAX package's gates (``ops/pallas/gather.py::supported`` and
``gather_tiles.py::supported``) exactly at every pyramid level of 480x640,
120x160 and 96x448 and at shapes on either side of the lane caps, and the
feature preset's operand takes the tile kernels where the JAX package
takes its own.  The kernels' plain versions are held in
``tests/test_torch_port_tiles.py``.
"""

import jax.numpy as jnp
import pytest

from deep_prob_feature_track_torch.ops.kernels import tiles
from deep_prob_feature_track_tpu.ops.pallas import gather as jgather
from deep_prob_feature_track_tpu.ops.pallas import gather_tiles as jtiles


def _levels(H, W):
    return [(H >> i, W >> i) for i in range(4)]


# every pyramid level of 480x640, 120x160 and 96x448; 481x640, which the
# edge-reach gate rejects; shapes on either side of the lane caps
ROUTE_SHAPES = (_levels(480, 640) + _levels(120, 160) + _levels(96, 448)
                + [(481, 640), (72, 96), (64, 240), (64, 288), (64, 408), (200, 700)])


@pytest.mark.parametrize("C", [5, 8, 10, 17])
@pytest.mark.parametrize("kind", ["eval", "grads"])
def test_use_tiles_matches_jax_route(kind, C):
    for H, W in ROUTE_SHAPES:
        for Hs, Ws in ((H, W), (H // 2, W // 2), (15, W), (H, 15)):
            ref = (not jgather.supported((2, H, W, C), jnp.float32, kind)
                   and jtiles.supported((2, H, W, C), (2, Hs, Ws), jnp.float32, kind))
            assert tiles.use_tiles(kind, H, W, C, Hs, Ws) == ref, (H, W, C, Hs, Ws)


def test_route_of_the_feature_preset_at_640x480():
    """The warp operand has C=10 after sigma-slim: level 0 takes K4 / K5,
    level 1 K1 for eval and K5 for training, levels 2-3 K1 / K2."""
    routes = [(tiles.use_tiles("eval", h, w, 10, h, w), tiles.use_tiles("grads", h, w, 10, h, w))
              for h, w in _levels(480, 640)]
    assert routes == [(True, True), (False, True), (False, False), (False, False)]
    assert not any(tiles.use_tiles(k, h, w, 10, h, w) for k in ("eval", "grads")
                   for h, w in _levels(120, 160))
    assert not tiles.use_tiles("grads", 480, 640, 17, 480, 640)  # XLA in JAX, K2 here
    with pytest.raises(ValueError):
        tiles.use_tiles("splat", 480, 640, 10, 480, 640)
