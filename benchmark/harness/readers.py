"""What the per-layer metrics' readers share. Each reader returns None
where its run has nothing to read, and the metric is then left out."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import yardstick


def mfu(run) -> Optional[float]:
    """Model FLOPs of the window's work over the window, against the
    chip's peak in the configuration's dtype (host clock)."""
    w = run.work
    if not w.get("window_s"):
        return None
    cfg = run.config
    per_window = run.cell.arch().model_flops(cfg, 1)
    flops = w["forward_windows"] * (3 if w["backward"] else 1) * per_window
    peak = yardstick.PEAK_FLOPS[cfg["model"]["dtype"]] * w.get("chips", 1)
    return 100.0 * flops / w["window_s"] / peak


def kernel_roofline(run) -> Optional[float]:
    """The sum of the bound times of the traced window's kernel operations
    over the sum of their device times: operations and shapes from the
    configuration's architecture and the traced work, device kernels
    mapped to operations by ``kernels/*.json``. An operation no traced
    kernel maps to is left out of both sums."""
    trace = run.trace
    if trace is None or not run.work.get("traced_calls"):
        return None
    cfg = run.config
    dtype = cfg["model"]["dtype"]
    arch = run.cell.arch()
    bound = {}
    for windows, count, backward in run.work["traced_calls"]:
        for (op, shape), n in arch.kernel_ops(cfg, windows, backward).items():
            flops, n_bytes = yardstick.work(op, shape, dtype)
            bound[op] = bound.get(op, 0.0) + count * n * yardstick.bound_s(flops, n_bytes, dtype)
    classes = yardstick.kernel_classes(str(run.cell.bench_dir / "kernels"))
    device = {}
    for name, seconds in trace.device_time_by_name().items():
        op = yardstick.op_of(name, classes)
        if op in bound:
            device[op] = device.get(op, 0.0) + seconds
    if not device:
        return None
    return 100.0 * sum(bound[op] for op in device) / sum(device.values())


def device_idle(run) -> Optional[float]:
    """The traced window's share with no device operation running."""
    trace = run.trace
    if trace is None:
        return None
    return 100.0 * (trace.window_s - trace.busy_s) / trace.window_s


def median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None
