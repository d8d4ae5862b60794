"""The correctness checks' controls and faults, on the chip.

Each stands in for the program and is held to the check a cell's runs
are held to, on the inputs and weights that cell draws from the seed, at
its sizes:

- ``tf32``: the plain reference with its matrix products in TF32, the
  precision below the float32 the configurations state (every cell);
- ``half_batch``: the reference's steps on half of each batch, the mean
  over the rest (training cells);
- ``no_exchange``: rank 0's steps on its own rows, with no all-reduce of
  the gradients between the ranks (cells over several cards).

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 --kind tf32

Prints one JSON line a seed with each compared number. The benchmark's
runs never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:1] = [BENCH, os.path.dirname(BENCH)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import checks, common, core, reference  # noqa: E402


def lift_inputs(ctx):
    """The videos a lift run checks: the longest length and others."""
    mix = ctx.mix
    lengths = common.lengths_plan(mix["lengths"], mix["lengths"]["count"], ctx.seed)
    longest = int(np.argmax(lengths))
    picks = [longest] + [i for i in range(len(lengths)) if i != longest][:mix["check_videos"] - 1]
    videos = [kp for kp, _ in common.make_videos(ctx, lengths)]
    return [videos[i] for i in picks]


def lift(ctx, kind):
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


def stream(ctx, kind):
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


def drop_seeds(ctx):
    """Each data-parallel rank's drop-path seed, as the program seeds it
    (``parallel.mesh.rank_seed``: the run's seed plus 1000003 a rank)."""
    return [ctx.seed + 1_000_003 * r for r in range(int(ctx.mix.get("ranks", 1)))]


def train(ctx, kind):
    """Batches drawn as the loader draws them (random windows of the
    archive, half of them flipped), then the stand-in's steps against the
    reference's."""
    from traffic.train_steps import archive_videos

    mix = ctx.mix
    seq_len, b = ctx.config["data"]["seq_len"], mix["batch_size"]
    archive = archive_videos(ctx)
    rng = np.random.default_rng([ctx.seed, 4])
    fed = []
    for _ in range(mix["checked_steps"]):
        xs, ys = [], []
        for _ in range(b):
            kp, pose = archive[rng.integers(len(archive))]
            s = rng.integers(len(kp) - seq_len)
            x, y = torch.from_numpy(kp[s:s + seq_len]), torch.from_numpy(pose[s:s + seq_len])
            if rng.uniform() < mix["flip_probability"]:
                x, y = reference.flip(x, ctx.config["skeleton"]), reference.flip(y, ctx.config["skeleton"])
            xs.append(x.numpy())
            ys.append(y.numpy())
        fed.append((np.stack(xs), np.stack(ys)))
    seeds = drop_seeds(ctx)
    stand_in = checks.follow(ctx, fed, seeds, tf32=kind == "tf32",
                             fault="" if kind == "tf32" else kind)
    start = {k: v.cpu() for k, v in common.draw_weights(ctx).items()}
    snapshots = {"first_grads": {k: v.cpu() for k, v in stand_in["first_grads"].items()},
                 "after": {k: start[k] + v.cpu() for k, v in stand_in["change"].items()}}
    losses = stand_in["losses"]
    del stand_in
    torch.cuda.empty_cache()
    out = checks.train_checks(ctx, fed, losses, snapshots, None, drop_seeds=seeds)
    return {c.name: c.value for c in out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", choices=("tf32", "half_batch", "no_exchange"), required=True)
    args = ap.parse_args()
    cell = core.Cell.find(args.workload)
    fn = {"lift_videos": lift, "stream_push": stream, "train_steps": train}[cell.mix["driver"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = core.Context(cell, seed, 0.0, False, "cuda", t0)
        numbers = fn(ctx, args.kind)
        limits = cell.mix["limits"]
        print(json.dumps({"workload": cell.name, "kind": args.kind, "seed": seed,
                          "numbers": numbers, "limits": {k: limits.get(k) for k in numbers},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
