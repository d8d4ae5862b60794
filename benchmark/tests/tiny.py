"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
files, with the model's widths and depths cut by its architecture's
``TINY`` and the mix's sizes and window by its driver's ``TINY`` and
``TINY_SEQ_LEN``."""

import copy
import time

from harness import core


def cell(config: str, traffic: str, name: str = "tiny") -> core.Cell:
    """A cell from its configuration's and mix's files alone, whether or
    not BENCHMARK.json lists it (the stream mix waits for a later PR)."""
    bench = core.BENCH_DIR
    return core.Cell(name, 1, core.load_json(bench / "configs" / f"{config}.json"),
                     core.load_json(bench / "mixes" / f"{traffic}.json"), [], [], bench)


def tiny(cell: core.Cell) -> core.Cell:
    c = copy.deepcopy(cell)
    driver, arch = c.driver(), c.arch()
    seq_len = driver.TINY_SEQ_LEN
    c.config["overrides"] = list(c.config["overrides"]) + [
        f"{group}.{k}={v}" for group, sizes in arch.TINY.items() for k, v in sizes.items()] + [
        f"data.seq_len={seq_len}"]
    for group, sizes in arch.TINY.items():
        c.config.setdefault(group, {}).update(sizes)
    c.config["data"]["seq_len"] = seq_len
    c.mix.update(copy.deepcopy(driver.TINY))
    if c.mix.get("ranks", 1) > 1:
        c.mix["ranks"] = 2
        c.mix["overrides"] = ["parallel.data=2", "parallel.mode=dp"]
        c.mix["checked_steps"] = 2
    return c


def run(cell: core.Cell, seed: int = 2**31 + 77, seconds: float = 1.0) -> dict:
    ctx = core.Context(cell, seed, seconds, False, "cpu", time.perf_counter())
    return core.run_cell(ctx)
