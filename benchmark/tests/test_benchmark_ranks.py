"""The data-parallel training mix (train-dp4) as two gloo ranks on the
CPU, at a tiny size: a sound run is correct, and one whose ranks never
exchange their gradients is not."""

import json
import multiprocessing
import os
import socket
import sys
import time


BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, out: str, fault: bool) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    sys.path[:0] = [os.path.join(BENCH, "tests"), BENCH, os.path.dirname(BENCH)]
    import torch

    torch.set_num_threads(1)
    import tiny
    from harness import core

    if fault:  # lay the model out, then drop the wrapper that all-reduces
        from manipose_tpu_torch.parallel import mesh

        shard = mesh.shard_params
        mesh.shard_params = lambda m, me, mode="tp": getattr(shard(m, me, mode), "module", m)
    cell = tiny.tiny(tiny.cell("manipose-h36m-243", "train-dp4"))
    ctx = core.Context(cell, 2**31 + 33, 1.0, False, "cpu", time.perf_counter(), rank, world)
    line = core.run_cell(ctx)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(line, f)


def _run(tmp_path, fault: bool) -> dict:
    mp = multiprocessing.get_context("spawn")
    out = str(tmp_path / "line.json")
    port = _free_port()
    procs = [mp.Process(target=_rank, args=(r, 2, port, out, fault)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
    with open(out) as f:
        return json.load(f)


def test_two_ranks_are_correct(tmp_path):
    line = _run(tmp_path, fault=False)
    assert line["correct"], line["checks"]


def test_ranks_that_never_exchange_are_caught(tmp_path):
    line = _run(tmp_path, fault=True)
    assert not line["correct"]
