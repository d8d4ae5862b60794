"""Spans, the profiler's device trace, and what is read from them.

Spans are the benchmark's own, around its calls into the program: kept in
memory as (name, start, end) on the host clock, and, in a traced run, also
as ``torch.profiler`` annotations (``bench.<name>``), so the trace shows
what the host was doing in each idle gap of the device. The trace is read
from the profiler's events in memory; nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaLaunchCooperativeKernel")
# what the device does: kernels and copies, not the profiler's markers of
# synchronisation (named "Context Sync", "Stream Wait Event", ...)
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_MARKERS = ("Sync", "Wait Event")
# host calls that wait for the device or copy, named in the idle gaps
HOST_WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync", "cudaHostAlloc", "cudaFreeHost")


class Spans:
    """In-memory spans by name, on the host clock (seconds)."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        cm = (torch.profiler.record_function("bench." + name) if self.annotate
              else contextlib.nullcontext())
        with cm:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.by_name[name].append((t0, time.perf_counter()))


class Trace:
    """What a traced window recorded: device operations with their
    intervals, the host's annotations, and the launch calls."""

    def __init__(self, device_ops, host_ops, launch_calls, window_ns):
        self.device_ops = device_ops  # [(name, start_ns, end_ns)] on the device
        self.host_ops = host_ops  # [(name, start_ns, end_ns)] annotations, cpu ops
        self.launch_calls = launch_calls  # count of kernel and graph launch calls
        self.window_ns = window_ns  # (start, end) of the traced window

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window_ns
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device_ops if b > lo and a < hi)
        merged: List[List[int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device_ops:
            out[name] += (b - a) * 1e-9
        return dict(out)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle time of the device by what the host was doing when each gap
        began: the innermost benchmark annotation or host operation open
        then (``host`` where none was)."""
        lo, hi = self.window_ns
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host_ops, key=lambda h: h[1])
        out: Dict[str, float] = defaultdict(float)
        i, open_ops = 0, []
        for a, b in gaps:
            while i < len(host) and host[i][1] <= a:
                open_ops.append(host[i])
                i += 1
            open_ops = [h for h in open_ops if h[2] >= a]
            name = max(open_ops, key=lambda h: h[1])[0] if open_ops else "host"
            out[name] += (b - a) * 1e-9
        return sorted(out.items(), key=lambda kv: -kv[1])


@contextlib.contextmanager
def traced(enabled: bool, result: dict):
    """Profile the enclosed window on the device (kernels, copies, launch
    calls) when ``enabled``; leaves a :class:`Trace` in ``result["trace"]``.
    The window is closed by a synchronisation inside it, so every device
    operation it started lies in it."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function("bench.window"):
            yield
            torch.cuda.synchronize()
    finally:
        prof.stop()
    result["trace"] = _read(prof)


def _device_work(event, name: str) -> bool:
    kind = getattr(event, "activity_type", None)  # not in every torch release
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return not any(m in name for m in SYNC_MARKERS)


def _read(prof) -> Trace:
    device_ops, host_ops, launches, window = [], [], 0, None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the annotations' spans on the device's timeline are no work
            if not name.startswith("bench.") and _device_work(e, name):
                device_ops.append((name, start, end))
        elif name == "bench.window":
            window = (start, end)
        elif name in LAUNCH_CALLS:
            launches += 1
        elif name.startswith("bench.") or name in HOST_WAITS:
            host_ops.append((name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no bench.window annotation")
    if not device_ops:
        raise RuntimeError("the profiler recorded no device activity in the window")
    return Trace(device_ops, host_ops, launches, window)
