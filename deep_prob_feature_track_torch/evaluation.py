"""Batched two-view evaluation and per-trajectory reporting.

Counterpart of ``deep_prob_feature_track_tpu/evaluation.py``: one loader
per (trajectory x keyframe), a no-grad forward per batch on the device
accumulating the per-frame R, t, EPE3D and RPE, and the summary table in
the reference's units (EPE and translation x100 -> cm, angle x180/pi ->
deg) with per-keyframe mean rows over trajectories and over frames.  The
table is a dict of rows, written to CSV with the ``csv`` module: the same
rows and columns as the JAX package's pandas table.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import losses
from .data.pipeline import BatchLoader, to_device
from .data.tum_dicts import EVAL_TRAJECTORIES

# structure/texture subsets of the TUM test scenes (ref evaluate.py:58-89)
SUBSET_TRAJECTORIES = {
    "nostructure": [
        "rgbd_dataset_freiburg3_nostructure_notexture_far",
        "rgbd_dataset_freiburg3_nostructure_notexture_near_withloop",
        "rgbd_dataset_freiburg3_nostructure_texture_far",
        "rgbd_dataset_freiburg3_nostructure_texture_near_withloop",
    ],
    "notexture": [
        "rgbd_dataset_freiburg3_nostructure_notexture_far",
        "rgbd_dataset_freiburg3_nostructure_notexture_near_withloop",
        "rgbd_dataset_freiburg3_structure_notexture_near",
    ],
    "structure_texture": [
        "rgbd_dataset_freiburg3_structure_texture_far",
        "rgbd_dataset_freiburg3_structure_texture_near",
    ],
}

KEYS = ("color0", "color1", "depth0", "depth1", "calib")
COLUMNS = ("3D EPE", "axis error", "trans error", "total frames", "keyframe", "trajectory")


def eval_trajectories(dataset: str, trajectory: str = "") -> List[str]:
    if trajectory == "":
        if dataset not in EVAL_TRAJECTORIES:
            raise ValueError(
                f"{dataset} has no default eval trajectories; pass --trajectory"
            )
        return EVAL_TRAJECTORIES[dataset]
    if trajectory in SUBSET_TRAJECTORIES:
        return SUBSET_TRAJECTORIES[trajectory]
    return [trajectory]


def create_eval_loaders(
    dataset: str,
    eval_type: str,
    keyframes: Sequence[int],
    batch_size: int = 8,
    trajectory: str = "",
    image_resize: float = 0.25,
    root: Optional[str] = None,
) -> Dict[str, BatchLoader]:
    """One loader per (trajectory x keyframe)."""
    from .data.loader import load_data

    loaders = {}
    for traj in eval_trajectories(dataset, trajectory):
        for kf in keyframes:
            ds = load_data(
                dataset, [kf], eval_type, select_traj=traj,
                image_resize=image_resize, root=root,
            )
            loaders[f"{traj}_keyframe_{kf}"] = BatchLoader(
                ds, batch_size=batch_size, shuffle=False
            )
    return loaders


def evaluate_two_view(loader: BatchLoader, forward_fn: Callable, device,
                      has_mask: bool = False, obj_only: bool = False,
                      timers=None) -> Dict[str, np.ndarray]:
    """The two-view eval loop.

    :param forward_fn: ``(color0, color1, depth0, depth1, K[, obj_mask0=,
        obj_mask1=]) -> (R, t)`` on tensors on ``device``
    :param has_mask: the batches hold object masks (MovingObjects3D): the
        EPE3D counts only the frame-0 object's pixels
    :param obj_only: with ``has_mask``, the masks also go to the forward,
        which then tracks the object
    :return: dict of per-frame arrays (R_est, t_est, epes, angular_error,
        translation_error) and the frames' ``names``; the padding of the
        last batch is dropped
    """
    out = {"R_est": [], "t_est": [], "names": [], "epes": [], "angular_error": [],
           "translation_error": []}

    for batch in loader:
        if timers:
            timers.tic("forward step")
        dev = to_device(batch, device)
        masks = {}
        if has_mask and obj_only:
            masks = {k: dev[k] for k in ("obj_mask0", "obj_mask1")}
        with torch.inference_mode():
            R, t = forward_fn(*(dev[k] for k in KEYS), **masks)
        if not isinstance(R, torch.Tensor):
            # an uncer_prop tracker's ((R, t), JtWJ): the JAX loop stops in
            # np.asarray of the (R, t) pair, with this error
            raise ValueError("the forward returned a pose and an information matrix, "
                             "not a pose: an uncer_prop tracker cannot be evaluated")
        if timers:
            timers.toc("forward step")

        if timers:
            timers.tic("evaluate")
        mask = batch["pad_mask"]
        out["R_est"].append(R.cpu().numpy()[mask])
        out["t_est"].append(t.cpu().numpy()[mask])
        R_gt, t_gt = dev["transform"][:, :3, :3], dev["transform"][:, :3, 3]
        with torch.inference_mode():
            ang, trs = losses.compute_rpe_error(R, t, R_gt, t_gt)
            depth0 = dev["depth0"]
            invalid = (depth0 == depth0.amin()) | (depth0 == depth0.amax())
            if has_mask and "obj_mask0" in dev:
                invalid = invalid | ~dev["obj_mask0"]
            epes = losses.compute_rt_epe_loss(R, t, R_gt, t_gt, depth0, dev["calib"],
                                              invalid=invalid)
        out["angular_error"].append(ang.cpu().numpy()[mask])
        out["translation_error"].append(trs.cpu().numpy()[mask])
        out["epes"].append(epes.cpu().numpy()[mask])
        names = batch.get("name", [])
        out["names"] += [n for n, m in zip(names, mask) if m]
        if timers:
            timers.toc("evaluate")

    # an empty loader fills no metric list: those keys are dropped, as the
    # JAX package drops them
    for key in ("epes", "angular_error", "translation_error"):
        if not out[key]:
            del out[key]
    return {
        k: (np.concatenate(v) if v and isinstance(v[0], np.ndarray) else v)
        for k, v in out.items()
    }


def summarize_results(
    per_loader: Dict[str, Dict[str, np.ndarray]],
    keyframes: Sequence[int],
    output_csv: Optional[str] = None,
    dump_dir: Optional[str] = None,
) -> Dict[str, Dict[str, object]]:
    """The per-trajectory table and the per-keyframe means, in cm and deg.

    :return: dict of rows, each a dict over ``COLUMNS`` (a mean row has no
        "total frames" or "trajectory"); written to ``output_csv`` with the
        row names in the first column, and each loader's results pickled
        to ``dump_dir/<loader>.pkl``
    """
    rows: Dict[str, Dict[str, object]] = {}
    for key, info in per_loader.items():
        traj, kf = key.split("_keyframe_")
        rows[key] = {
            "3D EPE": float(info["epes"].mean()) * 100.0,
            "axis error": float(info["angular_error"].mean()) * (180.0 / np.pi),
            "trans error": float(info["translation_error"].mean()) * 100.0,
            "total frames": int(info["R_est"].shape[0]),
            "keyframe": int(kf),
            "trajectory": traj,
        }
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            with open(os.path.join(dump_dir, key + ".pkl"), "wb") as f:
                pickle.dump(info, f)

    metrics = ("3D EPE", "axis error", "trans error")
    stats = {}
    for kf in keyframes:
        sub = [r for r in rows.values() if r["keyframe"] == kf]
        if not sub:
            continue
        stats[f"mean values of trajectories keyframe {kf}"] = {
            **{m: sum(r[m] for r in sub) / len(sub) for m in metrics}, "keyframe": kf}
        total = sum(r["total frames"] for r in sub)
        stats[f"mean values of frames keyframe {kf}"] = {
            **{m: sum(r[m] * r["total frames"] for r in sub) / total for m in metrics},
            "keyframe": kf}
    table = {**rows, **stats}
    if output_csv:
        os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
        with open(output_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["", *COLUMNS])
            for name, row in table.items():
                writer.writerow([name, *(row.get(c, "") for c in COLUMNS)])
    return table
