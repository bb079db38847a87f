"""The port's sigma-slim (``LeastSquareTracking._slim_sigma``): only the
broadcast sigma types are cut to one channel before the warp; the
``feature`` sigma, a head per channel, keeps all 8.  The heads themselves
are held against flax in ``tests/test_torch_port_heads.py``.
"""

import pytest
import torch

from deep_prob_feature_track_torch.models import presets as tp
from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking

B = 2


@pytest.mark.parametrize("uncertainty_type,kept", [("feature", 8), ("laplacian", 1),
                                                   ("sigmoid", 1), ("identity", 1)])
def test_slim_sigma_keeps_a_non_broadcast_sigma_whole(uncertainty_type, kept):
    """Only the broadcast sigma types are slimmed to one channel: the
    ``feature`` sigma has a head per channel and keeps all 8."""
    cfg = tp.apply_overrides(tp.get_preset("feature"), [f"uncertainty_type={uncertainty_type}"])
    net = LeastSquareTracking(cfg)
    sigmas = [torch.rand(B, 8, 16 >> i, 20 >> i) for i in range(4)]
    slim = net._slim_sigma(sigmas)
    assert [s.shape[1] for s in slim] == [kept] * 4
    for s, full in zip(slim, sigmas):
        assert torch.equal(s, full[:, :kept])
