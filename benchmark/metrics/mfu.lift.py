"""mfu.lift: the model's FLOPs of the window's work over the window,
against the chip's peak (harness/readers.py)."""

from harness import readers


def read(run):
    return readers.mfu(run)
