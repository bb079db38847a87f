"""Run logging: a stdout tee, scalar and image metrics, the code revision,
config fingerprints.

Counterpart of ``deep_prob_feature_track_tpu/utils/logger.py``.
``TeeLogger`` mirrors stdout to a log file.  ``MetricsLogger`` always
appends a JSONL stream (``metrics.jsonl``) and also writes TensorBoard
event files where ``torch.utils.tensorboard`` imports; a process that is
not the main one (``is_main_process=False``, every rank but 0 of a mesh)
writes nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional


def check_directory(filename: str):
    d = os.path.dirname(filename)
    if d and not os.path.exists(d):
        os.makedirs(d, exist_ok=True)


class TeeLogger:
    """Mirror stdout to ``filename`` (appended) until :meth:`close`."""

    def __init__(self, filename: str):
        check_directory(filename)
        self.terminal = sys.stdout
        self.file = open(filename, "a")
        sys.stdout = self

    def write(self, msg):
        self.terminal.write(msg)
        self.file.write(msg)

    def flush(self):
        self.terminal.flush()
        self.file.flush()

    def close(self):
        sys.stdout = self.terminal
        self.file.close()


def _tb_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # no tensorboard package: JSONL only
        return None
    return SummaryWriter(logdir)


class MetricsLogger:
    """Scalars of one run, appended to ``logdir/metrics.jsonl`` (and to
    TensorBoard event files there where TensorBoard imports); images go to
    TensorBoard alone.  With ``is_main_process=False`` nothing is written."""

    def __init__(self, logdir: str, is_main_process: bool = True):
        self.logdir = logdir
        self.is_main = is_main_process
        self.writer = None
        self.jsonl = None
        if self.is_main:
            os.makedirs(logdir, exist_ok=True)
            self.writer = _tb_writer(logdir)
            self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int):
        if not self.is_main:
            return
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        self.jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()})
            + "\n"
        )
        self.jsonl.flush()

    def image(self, tag: str, img, step: int):
        """:param img: [H,W,3] uint8 or float array; a no-op without
        TensorBoard"""
        if not self.is_main or self.writer is None:
            return
        self.writer.add_image(tag, img, step, dataformats="HWC")

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
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
