"""idle_in_dispatch.lift: the share of the traced window in which the
device was idle and the launching thread was starting a batch, in the
port's ``serve.dispatch`` span (pin, copy up, both passes' launches, copy
down): the device starved while the host launched
(harness/program_spans.py)."""

from harness import program_spans


def read(run):
    return program_spans.idle_share(run, ("serve",), ("serve.dispatch",))
