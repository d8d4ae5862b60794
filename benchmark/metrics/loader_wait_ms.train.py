"""loader_wait_ms.train: the mean wait a step, over the window, in the
benchmark's span around next() on the prefetch iterator."""


def read(run):
    w = run.work
    return 1e3 * w["loader_wait_s"] / w["steps"] if w.get("steps") else None
