"""push_p50_ms.stream: the median latency of every push that fired in the
window (host clock)."""

from harness import readers


def read(run):
    return readers.median(run.work["push_ms"])
