"""Canonical tracker presets.

Counterpart of ``deep_prob_feature_track_tpu/models/presets.py``; the
table is the same, and the tracker runs every preset.
"""

from __future__ import annotations

from .tracker import TrackerConfig

PRESETS = {
    "DeepIC": TrackerConfig(
        encoder_name="ConvRGBD2",
        direction="inverse",
        mest_type="MultiScale2w",
        solver_type="Direct-ResVol",
        feature_channel=1,
        feature_extract="average",
        uncertainty_type="None",
        combine_icp=False,
        scaler="None",
        init_pose_type="identity",
        train_init_pose=False,
        remove_tru_sigma=False,
    ),
    "RGB": TrackerConfig(
        encoder_name="RGB",
        uncertainty_type="None",
        direction="inverse",
        mest_type="None",
        solver_type="Direct-Nodamping",
        feature_channel=1,
        combine_icp=False,
        scaler="None",
        init_pose_type="identity",
        train_init_pose=False,
        remove_tru_sigma=False,
    ),
    "ICP": TrackerConfig(
        encoder_name="ICP",
        uncertainty_type="ICP",
        direction="inverse",
        mest_type="None",
        solver_type="Direct-Nodamping",
        combine_icp=False,
        scaler="None",
        init_pose_type="identity",
        train_init_pose=False,
        remove_tru_sigma=False,
    ),
    "RGB+ICP": TrackerConfig(
        encoder_name="RGB",
        uncertainty_type="identity",
        direction="inverse",
        mest_type="None",
        solver_type="Direct-Nodamping",
        uncertainty_channel=1,
        combine_icp=True,
        scaler="None",
        scale_scaler=0.2,
        init_pose_type="identity",
        train_init_pose=False,
        remove_tru_sigma=False,
    ),
    # the paper model
    "feature": TrackerConfig(
        encoder_name="ConvRGBD2",
        uncertainty_type="laplacian",
        direction="inverse",
        mest_type="None",
        solver_type="Direct-Nodamping",
        feature_channel=8,
        uncertainty_channel=1,
        feature_extract="conv",
        combine_icp=False,
        remove_tru_sigma=True,
        init_pose_type="sfm_net",
        train_init_pose=True,
        multi_hypo="prob_fuse",
    ),
    "feature_icp": TrackerConfig(
        encoder_name="ConvRGBD2",
        uncertainty_type="laplacian",
        direction="inverse",
        mest_type="None",
        solver_type="Direct-Nodamping",
        feature_channel=8,
        uncertainty_channel=1,
        feature_extract="conv",
        combine_icp=True,
        scale_scaler=0.01,
        remove_tru_sigma=True,
        init_pose_type="sfm_net",
        train_init_pose=True,
        multi_hypo="prob_fuse",
    ),
}


def get_preset(name: str) -> TrackerConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]
