"""Pieces the traffic drivers share: the drawn weights and inputs, the
port's objects built from them, closed-loop timing, and the comparisons."""

from __future__ import annotations

import sys
import time
from typing import List, Sequence

import numpy as np
import torch

from . import reference, synth


def log(ctx, what: str) -> None:
    """A line on standard error with the seconds since the run began."""
    print(f"[{time.perf_counter() - ctx.t_start:8.2f} s] {what}", file=sys.stderr, flush=True)


def check_port_config(ctx, port_cfg) -> None:
    """The port's Config has every size the configuration file states."""
    for group in ("model", "multi_hyp", "data"):
        for key, want in ctx.config.get(group, {}).items():
            if key in port_cfg[group] and port_cfg[group][key] != want:
                raise ValueError(f"{group}.{key}: the port runs {port_cfg[group][key]!r}, "
                                 f"configs/{ctx.config['name']}.json states {want!r}")


def draw_weights(ctx):
    """The configuration's weights drawn from the run's seed, by its
    architecture."""
    return ctx.arch.draw(ctx.config, ctx.seed, ctx.device)


def make_predictor(ctx, batch_size: int, tta: bool):
    """The port's Predictor with the drawn weights."""
    from manipose_tpu_torch.serving import Predictor

    log(ctx, "port imported")
    cfg = ctx.port_config()
    check_port_config(ctx, cfg)
    state = draw_weights(ctx)
    log(ctx, "weights drawn")
    return Predictor(cfg, ctx.port_skeleton(), state_dict=state,
                     batch_size=batch_size, tta=tta, device=ctx.device)


def lengths_plan(spec: dict, n: int, seed: int) -> List[int]:
    """``n`` video lengths: blocks of ``count`` lengths spread evenly from
    ``min`` to ``max``, every seed the same set a block. The seed orders
    each block as pairs of a short and a long length (the pairs, and the
    two in a pair, in its own order), so that any stretch of videos holds
    about the same mix of lengths: a window that ends inside a block
    lifts the same work a frame whatever the seed."""
    base = np.linspace(spec["min"], spec["max"], spec["count"]).round().astype(int)
    pairs = [(int(base[i]), int(base[-1 - i])) for i in range(len(base) // 2)]
    rng = np.random.default_rng([seed, 1])
    out = []
    while len(out) < n:
        for i in rng.permutation(len(pairs)):
            out += pairs[i] if rng.uniform() < 0.5 else pairs[i][::-1]
    return out[:n]


def make_videos(ctx, lengths: Sequence[int], stream: int = 0):
    """Host (keypoints, poses) pairs of the given lengths from the seed."""
    gen = torch.Generator(device=ctx.device).manual_seed(int(ctx.seed) * 7 + 1 + stream)
    return synth.host(synth.videos(lengths, ctx.config["camera"], ctx.config["skeleton"],
                                   gen, ctx.device))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def inputs_made(ctx) -> None:
    """The inputs are made: the device's peak from here on is the
    program's (the draws' scratch memory is freed and not counted)."""
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def pose_error(program: np.ndarray, ref: np.ndarray) -> float:
    """The largest coordinate gap over the largest reference coordinate."""
    if program.shape != ref.shape or not np.all(np.isfinite(program)):
        return float("inf")
    return float(np.max(np.abs(program.astype(np.float64) - ref)) / np.max(np.abs(ref)))


def reference_lift(ctx, windows: np.ndarray, tta: bool, tf32: bool = False,
                   block: int = 16) -> np.ndarray:
    """The reference's served poses of (W, L, J, 2) windows, in blocks."""
    arch = ctx.arch
    p = draw_weights(ctx)
    out = []
    with torch.no_grad(), reference.matmul_precision(tf32):
        for i in range(0, len(windows), block):
            x = torch.from_numpy(np.ascontiguousarray(windows[i:i + block])).to(ctx.device)
            out.append(arch.lift_windows(p, ctx.config, x, tta).double().cpu().numpy())
    return np.concatenate(out)


class Clock:
    """A closed-loop window: ``running()`` until ``seconds`` have passed."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = time.perf_counter()

    def running(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds
