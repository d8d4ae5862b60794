"""prefetch_wait_ms.train: the median of the port's ``data.wait`` spans
(the consumer's wait on the prefetch queue) over every batch of the
process."""

from harness import program_spans


def read(run):
    return program_spans.median_ms("data.wait")
