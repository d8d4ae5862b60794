"""idle_in_program.lift: the share of the traced window in which the
device was idle and the launching thread was inside one of the port's
``serve.*`` spans (harness/program_spans.py)."""

from harness import program_spans


def read(run):
    return program_spans.idle_share(run, ("serve",))
