"""device_idle.stream: the traced window's share with no device operation
running."""

from harness import readers


def read(run):
    return readers.device_idle(run)
