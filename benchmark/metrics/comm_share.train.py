"""comm_share.train: the share of rank 0's traced device time in NCCL's
kernels (the gradients' all-reduce between the cards)."""


def read(run):
    if run.trace is None:
        return None
    times = run.trace.device_time_by_name()
    total = sum(times.values())
    nccl = sum(t for name, t in times.items() if "nccl" in name.lower())
    return 100.0 * nccl / total if total else None
