"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
files, with the model's widths and depths and the mix's sizes cut."""

import copy
import time

from harness import core

TINY_MODEL = dict(layers=1, channels=32, nheads=2, layers_seg=1, channels_seg=16, nheads_seg=2)
MIXES = {
    "lift_videos": dict(batch_size=2, lengths={"min": 30, "max": 90, "count": 4}, videos=8,
                        warm_videos=1, check_videos=2),
    "stream_push": dict(frames=400, warm_pushes=6, check_frames=16, lookahead=4),
    "train_steps": dict(batch_size=4, lengths={"min": 60, "max": 120, "count": 4},
                        frames=30000, warm_steps=1),
}
SEQ_LEN = {"lift_videos": 27, "stream_push": 9, "train_steps": 27}


def cell(config: str, traffic: str, name: str = "tiny") -> core.Cell:
    """A cell from its configuration's and mix's files alone, whether or
    not BENCHMARK.json lists it (the stream mix waits for a later PR)."""
    bench = core.BENCH_DIR
    return core.Cell(name, 1, core.load_json(bench / "configs" / f"{config}.json"),
                     core.load_json(bench / "mixes" / f"{traffic}.json"), [], [], bench)


def tiny(cell: core.Cell) -> core.Cell:
    c = copy.deepcopy(cell)
    driver = c.mix["driver"]
    seq_len = SEQ_LEN[driver]
    c.config["overrides"] = list(c.config["overrides"]) + [
        f"model.{k}={v}" for k, v in TINY_MODEL.items()] + [
        "multi_hyp.n_hyp=2", f"data.seq_len={seq_len}"]
    c.config["model"].update(TINY_MODEL)
    c.config["multi_hyp"]["n_hyp"] = 2
    c.config["data"]["seq_len"] = seq_len
    c.mix.update(MIXES[driver])
    if c.mix.get("ranks", 1) > 1:
        c.mix["ranks"] = 2
        c.mix["overrides"] = ["parallel.data=2", "parallel.mode=dp"]
        c.mix["checked_steps"] = 2
    return c


def run(cell: core.Cell, seed: int = 2**31 + 77, seconds: float = 1.0) -> dict:
    ctx = core.Context(cell, seed, seconds, False, "cpu", time.perf_counter())
    return core.run_cell(ctx)
