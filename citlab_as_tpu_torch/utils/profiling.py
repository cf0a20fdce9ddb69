"""Tracing / profiling utilities (port of ``citlab_as_tpu/utils/profiling.py``).

Reference analogs: tf.estimator ProfilerHook gated by --profile_dir
(trainer_base.py:55,117-123) and ad-hoc wall-clock prints. Here:
``torch.profiler`` traces written as Chrome trace JSON (``chrome://tracing``
or Perfetto), CPU activity plus the card's when one is present, and a
lightweight stage timer that aggregates wall-clock per named section.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulating wall-clock timer: ``with timer.section("separator"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "mean_ms": round(1e3 * self.totals[name] / self.counts[name], 3)}
            for name in self.totals}

    def log_summary(self) -> None:
        for name, stats in sorted(self.summary().items()):
            logger.info("stage %-24s total=%.2fs n=%d mean=%.1fms",
                        name, stats["total_s"], stats["count"], stats["mean_ms"])


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block when ``log_dir`` is set,
    written to ``<log_dir>/trace_<ms since the epoch>.json``; a no-op
    otherwise (the --profile_dir gate of the reference)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    logger.info("Wrote profiler trace to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in profiler traces (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield
