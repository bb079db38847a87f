"""Wall-clock stage timers and profiler scopes.

Counterpart of ``deep_prob_feature_track_tpu/utils/timers.py``:
``Timers.time()`` scopes double as ``torch.profiler.record_function`` ranges,
so stages show in a profile, and ``block`` synchronises the card at each
``tic`` and ``toc``, so asynchronous launches do not fold every stage into
the last one that waits.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Timers:
    def __init__(self, block: bool = False):
        self.block = block
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._starts: Dict[str, float] = {}

    def tic(self, name: str):
        if self.block:
            self._sync()
        self._starts[name] = time.perf_counter()

    def toc(self, name: str):
        if name not in self._starts:
            return
        if self.block:
            self._sync()
        self.totals[name] += time.perf_counter() - self._starts.pop(name)
        self.counts[name] += 1

    @contextlib.contextmanager
    def time(self, name: str):
        """Timer and profiler range."""
        with torch.profiler.record_function(name):
            self.tic(name)
            try:
                yield
            finally:
                self.toc(name)

    @staticmethod
    def _sync():
        """Wait for the card, where this process uses one."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def mean(self, name: str) -> float:
        c = self.counts[name]
        return self.totals[name] / c if c else 0.0

    def summary(self) -> str:
        lines = ["stage timings (mean over calls):"]
        for name in sorted(self.totals):
            lines.append(
                f"  {name:<40s} {self.mean(name) * 1e3:9.3f} ms x{self.counts[name]}"
            )
        return "\n".join(lines)

    def print(self):
        print(self.summary())


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the block (host, and the card's
    kernels where one is in use) into ``logdir/trace.json`` (Chrome trace
    format)."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
