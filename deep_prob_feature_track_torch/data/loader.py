"""Dataset factory: ``get_dataset_root`` and ``load_data``.

Counterpart of ``deep_prob_feature_track_tpu/data/loader.py`` for the TUM
RGB-D, MovingObjects3D, ScanNet and VaryLighting datasets.  Dataset
roots resolve from (in order): an explicit ``root`` argument, the
``DPFT_DATA_ROOT`` environment variable, or a per-hostname entry in
``setup/datasets.yaml``, which needs PyYAML.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

from .transforms import ColorAugment


def get_dataset_root(dataset: str, root: Optional[str] = None) -> str:
    if root is not None:
        # explicit root ('' is valid for absolute-path select_traj mode)
        return root
    env = os.environ.get("DPFT_DATA_ROOT")
    if env:
        return os.path.join(env, dataset)
    yaml_path = os.path.join(os.path.dirname(__file__), "..", "..", "setup", "datasets.yaml")
    yaml_path = os.path.abspath(yaml_path)
    if os.path.isfile(yaml_path):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"the root of {dataset!r} would come from {yaml_path}, which needs PyYAML: "
                "pass --data_root (root=) or set DPFT_DATA_ROOT") from e

        with open(yaml_path) as f:
            cfg = yaml.safe_load(f) or {}
        entry = cfg.get(socket.gethostname(), cfg.get("default", {}))
        if dataset in entry:
            return entry[dataset]
    raise FileNotFoundError(
        f"no dataset root for {dataset!r}: pass root=, set DPFT_DATA_ROOT, "
        f"or add it to setup/datasets.yaml"
    )


def load_data(
    dataset: str,
    keyframes: Sequence[int],
    load_type: str = "train",
    select_traj: Optional[str] = None,
    image_resize: float = 0.25,
    truncate_depth: bool = True,
    root: Optional[str] = None,
    augment_seed: Optional[int] = None,
):
    """Create a dataset.

    :param dataset: TUM_RGBD, MovingObjects3D, ScanNet or VaryLighting
    :param load_type: train | validation | test | keyframe
    """
    augment = ColorAugment(seed=augment_seed) if load_type == "train" else None
    if dataset == "ScanNet":
        from .scannet import ScanNet

        return ScanNet(
            root=get_dataset_root("ScanNet", root),
            category="test" if load_type == "keyframe" else load_type,
            keyframes=list(keyframes),
            select_traj=select_traj,
            image_resize=image_resize,
            augment=augment,
        )
    if dataset == "MovingObjects3D":
        from .moving_objects import MovingObjects3D

        return MovingObjects3D(
            root=get_dataset_root("MovingObjects3D", root),
            category=load_type,
            keyframes=list(keyframes),
            select_traj=select_traj,
            image_resize=image_resize,
            augment=augment,
        )
    if dataset == "VaryLighting":
        from .vary_lighting import VaryLighting

        return VaryLighting(
            root=get_dataset_root("VaryLighting", root),
            category="test" if load_type == "keyframe" else load_type,
            keyframes=list(keyframes),
            select_traj=select_traj,
            image_resize=image_resize,
        )
    if dataset != "TUM_RGBD":
        raise ValueError(f"unsupported dataset {dataset!r}")
    from .tum import TUM

    return TUM(
        root=get_dataset_root("TUM_RGBD", root),
        category="test" if load_type == "keyframe" else load_type,
        keyframes=list(keyframes),
        select_traj=select_traj,
        image_resize=image_resize,
        truncate_depth=truncate_depth,
        augment=augment,
    )
