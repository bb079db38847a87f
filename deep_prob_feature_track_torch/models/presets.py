"""Canonical tracker presets.

Counterpart of ``deep_prob_feature_track_tpu/models/presets.py``; the
table is the same, and the tracker runs every preset.  A variant is named
as the JAX apps name it, ``apply_overrides(get_preset(name), pairs)``: the
forward-compositional ``U_FC`` track is the paper model with
``["direction=forward"]``.
"""

from __future__ import annotations

import dataclasses

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


def _coerce(raw: str, current, optional: bool = False):
    """Parse a ``key=value`` string by the type of the field's current value.

    ``none``/``null`` clears only Optional fields: several string fields
    use the literal string ``"None"`` as their sentinel (``mest_type``,
    ``scaler``, ``uncertainty_type``), and those stay strings.
    """
    if optional and raw.lower() in ("none", "null"):
        return None
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a boolean: {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        elem = type(current[0]) if current else int
        return tuple(elem(x) for x in raw.split(",") if x != "")
    if current is None:
        # an Optional field with a None default (scale_scaler): numbers
        # first, the string as the fallback
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
    return raw


def apply_overrides(cfg: TrackerConfig, pairs) -> TrackerConfig:
    """Apply ``key=value`` overrides onto a frozen config dataclass.

    Values are coerced by the field's current type; tuples parse
    comma-separated; ``none`` clears Optionals.  An unknown field or a
    value that does not parse raises ``SystemExit``, as the JAX apps'
    ``--set`` does.
    """
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for pair in pairs or ():
        key, sep, raw = pair.partition("=")
        if not sep or key not in fields:
            raise SystemExit(f"--set {pair!r}: unknown field {key!r}; valid: {sorted(fields)}")
        current = getattr(cfg, key)
        # annotations are strings under `from __future__ import annotations`
        optional = current is None or "Optional" in str(fields[key].type)
        try:
            updates[key] = _coerce(raw, current, optional)
        except ValueError as e:
            raise SystemExit(f"--set {pair!r}: {e}")
    return dataclasses.replace(cfg, **updates)
