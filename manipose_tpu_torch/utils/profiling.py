"""Profiling and instrumentation of the port.

``trace`` wraps ``torch.profiler`` (CPU activity, and CUDA activity when a
card is there) and exports one Chrome trace into ``run.profile_dir``;
``ThroughputMeter`` counts sequences a second over the steps after the
first (both ported from ``manipose_tpu/train/profiling.py``).

``span`` marks a stretch of host work at a layer boundary of the port: a
served video and its batches (``serve.*``, ``serving.Predictor``), a
loader item and its wait (``data.*``, ``data.pipeline``), a train step's
phases (``step``, ``step.*``, ``train.step``). Each span is kept in
memory on the clock that ``torch.profiler`` stamps host events with
(``time.time_ns()``), so spans line up with a device trace taken in the
same process. While a profiler records, each span is also a host event
``manipose.<name>`` in its trace (the ``run.profile_dir`` trace among
them), recorded as an operator's range and not as a user annotation: the
profiler copies a user annotation onto the device's timeline, where a
reader of device work that cannot tell it from a kernel would count it as
busy time. ``spans()``, ``totals()`` and ``reset()`` read and clear what
was recorded.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

# the most recent spans kept (about 1.6 MB): a benchmark run's every
# span, a long run's newest; the per-name totals count every span
RING_SIZE = 4096


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span, on ``thread``, between two ``time.time_ns()``
    readings."""

    name: str
    thread: int
    start_ns: int
    end_ns: int
    counts: Dict[str, int]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class SpanRecorder:
    """A bounded ring of the most recent spans, and per-name sums of each
    count that never drop. Any thread may record."""

    def __init__(self, size: int = RING_SIZE):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._totals: Dict[str, Dict[str, int]] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **counts: int) -> Iterator[None]:
        # a Python flag: no call into the profiler unless one records
        annotation = None
        if torch.autograd.profiler._is_profiler_enabled:
            annotation = torch._C._profiler._RecordFunctionFast("manipose." + name)
            annotation.__enter__()
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            if annotation is not None:
                annotation.__exit__(None, None, None)
            self._record(SpanRecord(name, threading.get_ident(), start, end, counts))

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._ring.append(rec)
            total = self._totals.setdefault(rec.name, {})
            for key, n in rec.counts.items():
                total[key] = total.get(key, 0) + n

    def spans(self) -> List[SpanRecord]:
        """The kept spans, oldest first."""
        with self._lock:
            return list(self._ring)

    def totals(self) -> Dict[str, Dict[str, int]]:
        """By span name, each count summed over every span since the last
        reset."""
        with self._lock:
            return {name: dict(t) for name, t in self._totals.items()}

    def reset(self) -> None:
        """Drop the kept spans and the totals (spans open now still record)."""
        with self._lock:
            self._ring.clear()
            self._totals.clear()


# the process's recorder, which the port's spans write to
_RECORDER = SpanRecorder()


def span(name: str, **counts: int):
    """A context manager recording one span ``name`` with integer ``counts``
    (two clock reads and an append; a profiler event more only while a
    profiler records)."""
    return _RECORDER.span(name, **counts)


def spans() -> List[SpanRecord]:
    return _RECORDER.spans()


def totals() -> Dict[str, Dict[str, int]]:
    return _RECORDER.totals()


def reset() -> None:
    _RECORDER.reset()


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """Profile the body into ``profile_dir/trace.json`` (open it in
    chrome://tracing or Perfetto; the port's spans show as ``manipose.*``).
    Without a directory it does nothing."""
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
