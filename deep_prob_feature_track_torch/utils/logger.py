"""Run logging: scalar metrics, the code revision, config fingerprints.

Counterpart of ``MetricsLogger``, ``git_revision`` and ``config_fingerprint``
in ``deep_prob_feature_track_tpu/utils/logger.py``.  ``MetricsLogger``
always appends a JSONL stream (``metrics.jsonl``) and also writes
TensorBoard event files where ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional


def _tb_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # no tensorboard package: JSONL only
        return None
    return SummaryWriter(logdir)


class MetricsLogger:
    """Scalars of one run, appended to ``logdir/metrics.jsonl`` (and to
    TensorBoard event files there where TensorBoard imports)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.writer = _tb_writer(logdir)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        self.jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()})
            + "\n"
        )
        self.jsonl.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        self.jsonl.close()


def git_revision(repo_dir: Optional[str] = None) -> str:
    """The code revision, for run logs ("unknown" outside a git checkout)."""
    try:
        out = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir, stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return out.decode().strip()


def config_fingerprint(cfg) -> str:
    """Compact run-name fingerprint of a ``TrackerConfig`` (the log
    directory's name packs the config, as the JAX package's does)."""
    parts = [
        cfg.encoder_name,
        cfg.mest_type,
        cfg.solver_type,
        f"uCh_{cfg.uncertainty_channel}",
        cfg.uncertainty_type,
        f"rmT_{cfg.remove_tru_sigma}",
        f"fCh_{cfg.feature_channel}",
        cfg.feature_extract,
        f"iP_{cfg.init_pose_type}",
        f"mH_{cfg.multi_hypo}",
        f"wICP_{cfg.combine_icp}",
    ]
    return "_".join(str(p) for p in parts)
