"""launch_calls_per_push.stream: kernel and graph launch calls (the
profiler's runtime-API activity) over the traced pushes."""


def read(run):
    n = run.work.get("traced_pushes")
    return run.trace.launch_calls / n if run.trace is not None and n else None
