"""TUM RGB-D sequence splits and calibration.

Dataset facts (sequence names, calibration, splits) from the TUM RGB-D
benchmark, a copy of ``deep_prob_feature_track_tpu/data/tum_dicts.py``.
"""

TUM_CALIB = [525.0, 525.0, 319.5, 239.5]

TUM_TRAINVAL = {
    "fr1": [
        "rgbd_dataset_freiburg1_desk2",
        "rgbd_dataset_freiburg1_floor",
        "rgbd_dataset_freiburg1_room",
        "rgbd_dataset_freiburg1_xyz",
        "rgbd_dataset_freiburg1_rpy",
        "rgbd_dataset_freiburg1_plant",
        "rgbd_dataset_freiburg1_teddy",
    ],
    "fr2": [
        "rgbd_dataset_freiburg2_360_hemisphere",
        "rgbd_dataset_freiburg2_large_no_loop",
        "rgbd_dataset_freiburg2_large_with_loop",
        "rgbd_dataset_freiburg2_pioneer_slam",
        "rgbd_dataset_freiburg2_pioneer_slam2",
        "rgbd_dataset_freiburg2_pioneer_slam3",
        "rgbd_dataset_freiburg2_xyz",
        "rgbd_dataset_freiburg2_rpy",
        "rgbd_dataset_freiburg2_coke",
        "rgbd_dataset_freiburg2_dishes",
        "rgbd_dataset_freiburg2_flowerbouquet_brownbackground",
        "rgbd_dataset_freiburg2_metallic_sphere2",
        "rgbd_dataset_freiburg2_flowerbouquet",
        "rgbd_dataset_freiburg2_360_kidnap",
        "rgbd_dataset_freiburg2_desk_with_person",
    ],
    "fr3": [
        "rgbd_dataset_freiburg3_cabinet",
        "rgbd_dataset_freiburg3_nostructure_notexture_far",
        "rgbd_dataset_freiburg3_nostructure_notexture_near_withloop",
        "rgbd_dataset_freiburg3_nostructure_texture_far",
        "rgbd_dataset_freiburg3_nostructure_texture_near_withloop",
        "rgbd_dataset_freiburg3_structure_notexture_near",
        "rgbd_dataset_freiburg3_structure_texture_far",
        "rgbd_dataset_freiburg3_structure_texture_near",
        "rgbd_dataset_freiburg3_teddy",
        "rgbd_dataset_freiburg3_walking_halfsphere",
        "rgbd_dataset_freiburg3_walking_rpy",
        "rgbd_dataset_freiburg3_sitting_rpy",
        "rgbd_dataset_freiburg3_sitting_static",
        "rgbd_dataset_freiburg3_sitting_xyz",
    ],
}

VARY_LIGHTING_TRAINVAL = {
    "vl": [
        "vl_auto_exp_xyz",
        "vl_autoexp_up",
        "vl_obj_180",
        "vl_obj_360",
        "vl_obj_lit",
        "vl_obj_lgt_rfl",
        "vl_rfl_book",
    ],
}

TUM_TEST = {
    "fr1": ["rgbd_dataset_freiburg1_360", "rgbd_dataset_freiburg1_desk"],
    "fr2": ["rgbd_dataset_freiburg2_desk", "rgbd_dataset_freiburg2_pioneer_360"],
}

# evaluation trajectory groups (ref code/evaluate.py:34-89)
EVAL_TRAJECTORIES = {
    "TUM_RGBD": [
        "rgbd_dataset_freiburg1_360",
        "rgbd_dataset_freiburg1_desk",
        "rgbd_dataset_freiburg2_desk",
        "rgbd_dataset_freiburg2_pioneer_360",
    ],
    "MovingObjects3D": ["boat", "motorbike"],
    "ScanNet": ["scene0565_00", "scene0011_00"],
}
