"""The back end's public helpers take the card by default, as the port's
entry points do: with no card they raise and name ``device='cpu'``, and
never fall back to the CPU on their own.  ``apps/ba_refine.py`` itself is
held against the JAX package in ``tests/test_torch_port_ba_refine.py``.
"""

import numpy as np
import pytest
import torch

from deep_prob_feature_track_torch.apps import ba_refine as pba


@pytest.mark.parametrize("call", ["build_window_graph", "track_pairs", "track_window",
                                  "encode_frames", "resize_batch", "synthetic_batch",
                                  "example_batch", "warp_residual_mosaic"])
def test_helpers_run_on_the_card_unless_asked(monkeypatch, call):
    """The back end's public helpers take the card by default, as the
    package's entry points do: without one they raise and name
    ``device='cpu'``, and never fall back to the CPU on their own."""
    from deep_prob_feature_track_torch.apps import run_example, serve, warping_objects
    from deep_prob_feature_track_torch.parallel import ba
    from deep_prob_feature_track_torch.training import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"build_window_graph": lambda: ba.build_window_graph(np.eye(4)[None], [], []),
          "track_pairs": lambda: pba.track_pairs(None, [(0, 1)], None),
          "track_window": lambda: pba.track_window(None, None, 2, 1),
          "encode_frames": lambda: pba.encode_frames(None, None, 1, 0),
          "resize_batch": lambda: run_example.resize_batch({}),
          "synthetic_batch": lambda: train.synthetic_batch(1, 8, 8),
          "example_batch": lambda: serve.example_batch(1, 8, 8),
          "warp_residual_mosaic": lambda: warping_objects.warp_residual_mosaic({}, None, "x")}[call]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
