"""Profiling and throughput instrumentation.

Port of ``manipose_tpu/train/profiling.py``: ``trace`` wraps
``torch.profiler`` (CPU activity, and CUDA activity when a card is there)
and exports one Chrome trace into ``run.profile_dir``; ``ThroughputMeter``
counts sequences a second over the steps after the first.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Profile the body into ``profile_dir/trace.json`` (open it in
    chrome://tracing or Perfetto). Without a directory it does nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


class ThroughputMeter:
    """sequences/sec over a window that starts at the second step."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._seen_first = False
        self._sequences = 0
        self._steps = 0

    def step(self, batch_size: int) -> None:
        # step() is called before each train step is launched; the first
        # step builds kernels and warms caches, so the clock starts at the
        # second call and the first step is left out of the window
        if not self._seen_first:
            self._seen_first = True
            return
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._sequences += batch_size
        self._steps += 1

    @property
    def seq_per_sec(self) -> float:
        if not self._t0 or not self._steps:
            return 0.0
        return self._sequences / (time.perf_counter() - self._t0)

    @property
    def ms_per_step(self) -> float:
        if not self._t0 or not self._steps:
            return 0.0
        return (time.perf_counter() - self._t0) / self._steps * 1e3
