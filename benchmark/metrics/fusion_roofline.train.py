"""fusion_roofline.train: the stream fusion kernels' bound time (the
architecture's ``fusion_work`` over the traced steps, at
``yardstick.bound_s``) over their device time in the traced window
(kernels/stream-fusion.json). None for an architecture without a fusion."""

from harness import op_time, yardstick


def read(run):
    fusion_work = getattr(run.cell.arch(), "fusion_work", None)
    seconds = op_time.device_s(run, "stream_fusion")
    if fusion_work is None or seconds is None or not run.work.get("traced_calls"):
        return None
    cfg = run.config
    dtype = cfg["model"]["dtype"]
    bound = sum(count * yardstick.bound_s(*fusion_work(cfg, windows, backward), dtype)
                for windows, count, backward in run.work["traced_calls"])
    return 100.0 * bound / seconds
