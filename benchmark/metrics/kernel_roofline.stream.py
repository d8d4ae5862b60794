"""kernel_roofline.stream: the traced kernels' bound time over their device
time (harness/readers.py, kernels/*.json)."""

from harness import readers


def read(run):
    return readers.kernel_roofline(run)
