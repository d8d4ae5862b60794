"""useful_frames.lift: the frames of every video the process lifted (the
port's ``serve.video`` count ``frames``) over the frame slots the device
ran for them (``serve.dispatch`` count ``rows``, padding included, times
the window's length)."""

from harness import program_spans


def read(run):
    prof = program_spans.recorder()
    if prof is None:
        return None
    totals = prof.totals()
    frames = totals.get("serve.video", {}).get("frames")
    rows = totals.get("serve.dispatch", {}).get("rows")
    if not frames or not rows:
        return None
    return 100.0 * frames / (rows * run.config["data"]["seq_len"])
