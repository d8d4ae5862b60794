"""Live streaming: one camera stream pushes one frame at a time into a
``StreamingSession`` (``Predictor.stream``), in a closed loop: each push is
sent when the previous one has returned, as an application that waits for
each pose does. Every push past the lookahead fires one window's forward
(TTA as the mix says) and returns one pose.

``push_p95_ms``: the 95th percentile of the latency of all pushes that
fire in the window.
"""

from __future__ import annotations

import time

import numpy as np

from harness import common, core, reference, tracing

# the mix's sizes and the window's length in the benchmark's tiny runs
TINY = dict(frames=400, warm_pushes=6, check_frames=16, lookahead=4)
TINY_SEQ_LEN = 9


def run(ctx) -> core.Outcome:
    mix = ctx.mix
    seq_len = ctx.config["data"]["seq_len"]
    lookahead = mix["lookahead"]
    spans = tracing.Spans(annotate=ctx.trace)
    pred = common.make_predictor(ctx, mix["batch_size"], mix["tta"])
    frames = common.make_videos(ctx, [mix["frames"]])[0][0]
    common.log(ctx, "predictor built, frames drawn")
    common.inputs_made(ctx)
    session = pred.stream(stride=mix["stride"], lookahead=lookahead)
    emitted = []  # every pose the session returned, in order
    latencies = []
    state = {"next": 0}

    def push():
        i = state["next"] % len(frames)
        state["next"] += 1
        t = time.perf_counter()
        with spans.span("push"):
            out = session.push(frames[i])
        latency = time.perf_counter() - t
        emitted.extend(out)
        return latency, len(out)

    # warm-up: the stream's start (replicate-padded windows) and firing pushes
    for _ in range(mix["warm_pushes"]):
        push()
    common.sync(ctx.device)
    common.log(ctx, "warmed up")
    clock = common.Clock(ctx.seconds)
    setup_s = clock.t0 - ctx.t_start
    fired = 0
    while clock.running():
        latency, n = push()
        if n:
            latencies.append(latency)
            fired += 1
    elapsed = time.perf_counter() - clock.t0
    result = {}
    if ctx.trace:
        with tracing.traced(True, result):
            for _ in range(mix["trace_pushes"]):
                push()
    pushed = state["next"]
    lat_ms = np.asarray(latencies) * 1e3
    passes = 2 if mix["tta"] else 1
    traced = mix["trace_pushes"] if ctx.trace else 0
    work = {"pushes": fired, "window_s": elapsed, "push_ms": lat_ms, "traced_pushes": traced,
            "forward_windows": fired * passes, "backward": False,
            "traced_calls": [(1, traced * passes, False)]}
    failed = pushed - lookahead - len(emitted)  # pushes past the lookahead that gave no pose
    del pred, session
    quarters = [np.percentile(q, [50, 95]).round(2).tolist()
                for q in np.array_split(lat_ms, 4)] if len(lat_ms) >= 4 else []
    common.log(ctx, f"window: {fired} pushes in {elapsed:.3f} s; ms (p50, p95) by quarter "
                    f"{quarters}")
    if pushed > len(frames):
        raise RuntimeError(f"{pushed} pushes outran the mix's {len(frames)} frames")

    def check():
        # emitted pose t comes from the window ending at frame t + lookahead
        rng = np.random.default_rng([ctx.seed, 3])
        n = len(emitted)
        first = list(range(min(n, seq_len - lookahead)))  # the padded windows
        rest = rng.choice(np.arange(len(first), n), replace=False,
                          size=min(n - len(first), max(0, mix["check_frames"] - len(first))))
        picks = np.asarray(first + sorted(rest.tolist()), np.int64)
        wins = np.stack([reference.stream_window(frames, int(t) + lookahead, seq_len)
                         for t in picks])
        ref = common.reference_lift(ctx, wins, mix["tta"], block=64)[:, seq_len - 1 - lookahead]
        got = np.stack([emitted[t] for t in picks])
        err = common.pose_error(got, ref)
        return [core.Check("pose_err", err, ctx.mix["limits"]["pose_err"])]

    return core.Outcome(setup_s, {"push_p95_ms": float(np.percentile(lat_ms, 95))}, pushed,
                        max(failed, 0), work, spans, check, result.get("trace"))


def control(ctx, kind):
    """The reference in TF32 standing in for the program (``controls.py``)."""
    if kind != "tf32":
        raise ValueError(f"no {kind} fault for a stream cell")
    mix = ctx.mix
    seq_len, lookahead = ctx.config["data"]["seq_len"], mix["lookahead"]
    frames = common.make_videos(ctx, [mix["frames"]])[0][0]
    n = mix["check_frames"]
    picks = np.arange(n)  # the stream's start and what follows
    wins = np.stack([reference.stream_window(frames, int(t) + lookahead, seq_len) for t in picks])
    ref = common.reference_lift(ctx, wins, mix["tta"], block=64)[:, seq_len - 1 - lookahead]
    got = common.reference_lift(ctx, wins, mix["tta"], tf32=True, block=64)
    got = got[:, seq_len - 1 - lookahead].astype(np.float32)
    return {"pose_err": common.pose_error(got, ref)}
