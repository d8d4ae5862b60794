"""fusion_share.train: the stream fusion kernels' device time over the
traced window's busy time (kernels/stream-fusion.json)."""

from harness import op_time


def read(run):
    seconds = op_time.device_s(run, "stream_fusion")
    if seconds is None:
        return None
    return 100.0 * seconds / run.trace.busy_s
