"""The port's own spans (``manipose_tpu_torch.utils.profiling``), for the
per-layer metrics that read them. The port stamps its spans with
``time.time_ns()``, the clock of the profiler's host events and of the
device intervals it places beside them, so a span lines up with a traced
window's idle gaps. A checkout whose port has no span module (one from
before the port recorded spans) gives None from every reader here, and
its metrics are left out; an import that fails inside the module raises.
"""

from __future__ import annotations

import importlib
import importlib.util
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from .tracing import Trace

MODULE = "manipose_tpu_torch.utils.profiling"


def recorder():
    """The port's span module, or None where the port has none."""
    if importlib.util.find_spec(MODULE) is None:
        return None
    return importlib.import_module(MODULE)


def idle_by_span(run, layers: Sequence[str]) -> Optional[Dict[str, float]]:
    """Idle seconds of the traced window by the innermost span of ``layers``
    (layer ``step`` holds ``step`` and every ``step.*``) open on the
    launching (main) thread when each gap began, ``host`` where none was:
    ``Trace.idle_gaps`` with the port's spans as the host's operations."""
    prof = recorder()
    if prof is None or run.trace is None:
        return None
    main = threading.main_thread().ident
    ops = [(r.name, r.start_ns, r.end_ns) for r in prof.spans()
           if r.thread == main and r.name.split(".", 1)[0] in layers]
    if not ops:
        return None
    trace = run.trace
    return dict(Trace(trace.device_ops, ops, 0, trace.window_ns).idle_gaps())


def idle_share(run, layers: Sequence[str], names: Optional[Sequence[str]] = None
               ) -> Optional[float]:
    """The share of the traced window in which the device was idle and the
    innermost span of ``layers`` open on the launching thread was one of
    ``names`` (any span of ``layers`` where ``names`` is None)."""
    by_span = idle_by_span(run, layers)
    if by_span is None:
        return None
    inside = sum(s for name, s in by_span.items()
                 if name != "host" and (names is None or name in names))
    return 100.0 * inside / run.trace.window_s


def median_ms(name: str) -> Optional[float]:
    """The median length of every kept span ``name``, in ms."""
    prof = recorder()
    if prof is None:
        return None
    lengths = [r.seconds for r in prof.spans() if r.name == name]
    return 1e3 * float(np.median(lengths)) if lengths else None
