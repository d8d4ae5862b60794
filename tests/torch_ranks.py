"""Start a small world of gloo CPU ranks for the port's multi-rank tests.

Each rank is a process running ``tests/torch_rank_worker.py <task> <dir>``
with the environment ``torchrun`` would give it (MASTER_ADDR, MASTER_PORT,
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) and one intra-op thread.
The worker imports torch and the port only; it reads its inputs from and
writes its results to ``<dir>``, where the test compares them with the JAX
package's.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_rank_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
               WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return env


def run_ranks(world: int, task: str, out_dir: Path, timeout: float = 300) -> None:
    """Run ``task`` on ``world`` ranks; raise with the failing ranks' output
    if any rank fails or the world outlives ``timeout`` seconds."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), task, str(out_dir)],
                              cwd=ROOT, env=rank_env(r, world, port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, out) for r, (p, out) in enumerate(zip(procs, outputs)) if p.returncode]
    if failed or len(outputs) < world:
        raise RuntimeError("\n".join(f"rank {r}:\n{out[-4000:]}" for r, out in failed)
                           or f"{task}: a rank did not finish in {timeout} s")


def torchrun(nproc: int, module: str, args, timeout: float = 300) -> str:
    """``torchrun --standalone --nproc-per-node nproc -m module *args`` from
    the repository root; returns its output, raises with it on failure."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           f"--nproc-per-node={nproc}", "-m", module, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    out = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"torchrun {module} failed ({proc.returncode}):\n{out[-6000:]}")
    return out
