"""The port's tracker builds from every value of every ``TrackerConfig``
field the JAX package accepts, and refuses an encoder or an initial pose
type it does not know.  The modules those values select are held against
flax in ``tests/test_torch_port_variants.py``.
"""

import dataclasses

import pytest

from deep_prob_feature_track_torch.models.tracker import LeastSquareTracking, TrackerConfig


# every value of every field the JAX package's TrackerConfig accepts
VALUES = {
    "encoder_name": ("RGB", "ConvRGBD", "ConvRGBD2", "ICP"),
    "direction": ("inverse", "forward"),
    "mest_type": ("None", "Huber", "MultiScale2w"),
    "solver_type": ("Direct-Nodamping", "Direct-ResVol"),
    "feature_extract": ("1by1", "conv", "skip", "average", "prob_fuse"),
    "scaler": ("None", "oneResidual", "twoResidual", "MultiScale2w", "expMultiScale"),
    "init_pose_type": ("identity", "sfm_net", "dense_net"),
    "multi_hypo": ("None", "average", "prob_fuse"),
    "res_input": (False, True),
    "uncer_prop": (False, True),
    "no_weight_sharing": (False, True),
    "combine_icp": (False, True),
    "train_init_pose": (False, True),
    "remove_tru_sigma": (False, True),
}


@pytest.mark.parametrize("field", sorted(VALUES))
def test_every_tracker_config_value_builds(field):
    for value in VALUES[field]:
        cfg = dataclasses.replace(TrackerConfig(combine_icp=True), **{field: value})
        LeastSquareTracking(cfg)
    with pytest.raises(ValueError):
        LeastSquareTracking(TrackerConfig(encoder_name="ConvRGBD3"))
    with pytest.raises(ValueError):
        LeastSquareTracking(TrackerConfig(init_pose_type="flow_net"))
