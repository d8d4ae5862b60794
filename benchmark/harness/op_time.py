"""The device time of one kernel operation in a traced window, for the
per-layer metrics of a kernel class that the architecture's
``kernel_ops`` does not count (``kernels/<class>.json`` maps the device
kernels' names to the operation)."""

from __future__ import annotations

from typing import Optional

from . import yardstick


def device_s(run, op: str) -> Optional[float]:
    """Seconds the traced window's kernels of ``op`` ran on the device, or
    None where the run has no trace or none of them ran."""
    if run.trace is None:
        return None
    classes = yardstick.kernel_classes(str(run.cell.bench_dir / "kernels"))
    seconds = sum(s for name, s in run.trace.device_time_by_name().items()
                  if yardstick.op_of(name, classes) == op)
    return seconds or None
