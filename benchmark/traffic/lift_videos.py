"""Offline lifting: one client lifts whole keypoint videos one after the
other through ``Predictor.predict_video`` (non-overlapping windows, the
mix's window batch, TTA), in a closed loop as a batch job does.

``frames_per_s``: the frames of every video begun in the window over the
time from the window's start to the end of the last of them.
"""

from __future__ import annotations

import time

import numpy as np

from harness import common, core, reference, tracing

# the mix's sizes and the window's length in the benchmark's tiny runs
TINY = dict(batch_size=2, lengths={"min": 30, "max": 90, "count": 4}, videos=8, warm_videos=1,
            check_videos=2)
TINY_SEQ_LEN = 27


def run(ctx) -> core.Outcome:
    mix = ctx.mix
    seq_len = ctx.config["data"]["seq_len"]
    spans = tracing.Spans(annotate=ctx.trace)
    pred = common.make_predictor(ctx, mix["batch_size"], mix["tta"])
    lengths = common.lengths_plan(mix["lengths"], mix["videos"], ctx.seed)
    common.log(ctx, "predictor built")
    videos = [kp for kp, _ in common.make_videos(ctx, lengths)]
    common.log(ctx, f"{len(videos)} videos drawn")
    common.inputs_made(ctx)
    # warm-up: the one batch shape every video uses
    for i in range(mix["warm_videos"]):
        pred.predict_video(videos[-1 - i])
        common.log(ctx, f"warm-up video {i} lifted")
    common.sync(ctx.device)
    common.log(ctx, "warmed up")

    lifted = []  # (video index, poses)

    def lift(i):
        v = videos[i % len(videos)]
        with spans.span("predict_video"):
            lifted.append((i % len(videos), pred.predict_video(v)))

    clock = common.Clock(ctx.seconds)
    setup_s = clock.t0 - ctx.t_start
    i = 0
    while clock.running():
        lift(i)
        i += 1
    elapsed = time.perf_counter() - clock.t0
    in_window = list(lifted)
    frames = sum(len(videos[k]) for k, _ in in_window)
    windows_needed = sum(common.ceil_div(len(videos[k]), seq_len) for k, _ in in_window)
    result = {}
    if ctx.trace:
        with tracing.traced(True, result):
            for _ in range(mix["trace_videos"]):
                lift(i)
                i += 1
    traced = lifted[len(in_window):]
    batches = sum(common.ceil_div(common.ceil_div(len(videos[k]), seq_len), mix["batch_size"])
                  for k, _ in traced)
    failed = sum(1 for k, out in lifted
                 if out.shape != (len(videos[k]),) + videos[k].shape[1:-1] + (3,)
                 or not np.all(np.isfinite(out)))
    passes = 2 if mix["tta"] else 1
    work = {"frames": frames, "videos": len(in_window), "window_s": elapsed,
            "forward_windows": windows_needed * passes, "backward": False,
            "traced_calls": [(mix["batch_size"], batches * passes, False)]}
    del pred
    per = [(len(videos[k]), round(b - a, 4)) for (k, _), (a, b) in
           zip(in_window, spans.by_name["predict_video"])]
    common.log(ctx, f"window: {len(in_window)} videos, {frames} frames in {elapsed:.3f} s; "
                    f"(frames, s) {per}")

    def check():
        # a sample drawn from the seed, with the longest video lifted in it
        rng = np.random.default_rng([ctx.seed, 2])
        longest = max(range(len(lifted)), key=lambda j: len(lifted[j][1]))
        others = [j for j in range(len(lifted)) if j != longest]
        picks = [longest] + list(rng.choice(others, size=min(len(others), mix["check_videos"] - 1),
                                            replace=False))
        worst = 0.0
        for j in picks:
            k, out = lifted[j]
            wins = reference.tile_video(videos[k], seq_len)
            ref = common.reference_lift(ctx, wins, mix["tta"]).reshape(-1, *out.shape[1:])
            worst = max(worst, common.pose_error(out, ref[:len(out)]))
        return [core.Check("pose_err", worst, ctx.mix["limits"]["pose_err"])]

    return core.Outcome(setup_s, {"frames_per_s": frames / elapsed}, len(lifted), failed, work,
                        spans, check, result.get("trace"))


def lift_inputs(ctx):
    """The videos a lift run checks: the longest length and others."""
    mix = ctx.mix
    lengths = common.lengths_plan(mix["lengths"], mix["lengths"]["count"], ctx.seed)
    longest = int(np.argmax(lengths))
    picks = [longest] + [i for i in range(len(lengths)) if i != longest][:mix["check_videos"] - 1]
    videos = [kp for kp, _ in common.make_videos(ctx, lengths)]
    return [videos[i] for i in picks]


def control(ctx, kind):
    """The reference in TF32 standing in for the program (``controls.py``)."""
    if kind != "tf32":
        raise ValueError(f"no {kind} fault for a lift cell")
    seq_len = ctx.config["data"]["seq_len"]
    worst = 0.0
    for video in lift_inputs(ctx):
        wins = reference.tile_video(video, seq_len)
        ref = common.reference_lift(ctx, wins, ctx.mix["tta"]).reshape(-1, *video.shape[1:-1], 3)
        got = common.reference_lift(ctx, wins, ctx.mix["tta"], tf32=True)
        got = got.reshape(ref.shape).astype(np.float32)
        worst = max(worst, common.pose_error(got, ref[:len(got)]))
    return {"pose_err": worst}
