"""batch_make_ms.train: the median of the port's ``data.produce`` spans
(one batch made and pinned on the prefetch thread) over every batch of
the process."""

from harness import program_spans


def read(run):
    return program_spans.median_ms("data.produce")
