"""Run one cell once: find its files by name, check the machine, set up,
measure, check the outputs against the plain reference, print the line.

Everything that belongs to one configuration, traffic mix, traffic
driver, per-layer metric or kernel class is a file of its own, found by
the name that ``BENCHMARK.json`` or a mix gives:

- ``configs/<config>.json``: the configuration as run (the port's config
  overrides, the sizes the reference reads, the skeleton, the camera);
- ``archs/<model.arch>.py``: the configuration's architecture: its plain
  reference, weights, loss, optimizer and yardstick (``archs/rmcl_manifold.py``
  gives the interface);
- ``mixes/<traffic>.json``: a traffic mix, ``{"driver": ..., params}``;
- ``traffic/<driver>.py``: a traffic driver, ``run(ctx) -> Outcome``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``;
- ``kernels/<class>.json``: device kernel names -> the operation they do.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names no run may load (compared whole: the port's own
# name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "manipose_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def cache_dirs(root: Path) -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its kernels into ``build/kernels`` there by itself), the Python
    bytecode of every module a run imports among them."""
    base = root / "build" / "bench-cache"
    return {"PYTHONPYCACHEPREFIX": str(base / "pycache"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
            "CUDA_CACHE_PATH": str(base / "cuda")}


def use_bytecode_cache() -> None:
    """Compile each module once per checkout: with bytecode writes off, as
    where ``PYTHONDONTWRITEBYTECODE`` is set, every run would compile the
    sources of torch and the port anew on the host's cores (some 1,700
    modules, 8 s of set-up on an H100 machine). This process and the ranks it starts read and write
    bytecode under ``PYTHONPYCACHEPREFIX``."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell with every file it names, read from ``bench_dir``."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    @classmethod
    def find(cls, name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> "Cell":
        spec = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        w = cells[name]
        config = load_json(bench_dir / "configs" / f"{w['config']}.json")
        mix = load_json(bench_dir / "mixes" / f"{w['traffic']}.json")

        def mine(metric):
            return name in metric.get("workloads", [name])

        return cls(name, int(w["chips"]), config, mix,
                   [m for m in spec["end_to_end"] if mine(m)],
                   [m for m in spec["per_layer"] if mine(m)], bench_dir)

    def driver(self):
        return load_module(self.bench_dir / "traffic" / f"{self.mix['driver']}.py",
                           "bench_traffic_" + self.mix["driver"])

    def arch(self):
        name = self.config["model"]["arch"]
        return load_module(self.bench_dir / "archs" / f"{name}.py", "bench_arch_" + name)

    def reader(self, metric: str) -> Callable:
        module = load_module(self.bench_dir / "metrics" / f"{metric}.py",
                             "bench_metric_" + metric.replace(".", "_").replace("-", "_"))
        return module.read


@dataclasses.dataclass
class Check:
    """One number compared with its limit; it passes at or under it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a traffic driver is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the chip; "cpu" only in the benchmark's own tests
    t_start: float  # the process's start on the host clock
    rank: int = 0
    world: int = 1

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def arch(self):
        return self.cell.arch()

    def port_config(self, extra=()):
        """The port's Config for this configuration, seeded by the run."""
        from manipose_tpu_torch.config import load_config

        return load_config("config", list(self.config["overrides"])
                           + list(self.mix.get("overrides", ())) + list(extra)
                           + [f"run.seed={self.seed}"])

    def port_skeleton(self):
        """The configuration's skeleton as the port's ``Skeleton``."""
        from manipose_tpu_torch.geometry.skeleton import Skeleton

        s = self.config["skeleton"]
        return Skeleton(parents=tuple(s["parents"]), joints_left=tuple(s["joints_left"]),
                        joints_right=tuple(s["joints_right"]),
                        t_pose_operators=tuple(tuple(t) for t in s["t_pose"]))


@dataclasses.dataclass
class Outcome:
    """What a driver's run gives back. ``end_to_end``: the cell's host-clock
    metrics but ``setup_s``; ``work``: counts the readers use; ``check``:
    called once the program's state is freed, returns the comparisons."""

    setup_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    work: dict
    spans: object
    check: Callable[[], List[Check]]
    trace: Optional[object] = None
    memory_peak_bytes: int = 0


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""

    cell: Cell
    outcome: Outcome

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def work(self) -> dict:
        return self.outcome.work

    @property
    def trace(self):
        return self.outcome.trace


def memory_peak_bytes(device: str) -> int:
    """This process's peak on the cards it used."""
    import torch

    if device != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(torch.cuda.current_device())


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unavailable"
    except (OSError, subprocess.SubprocessError):
        return "unavailable"


def breakdown(trace) -> dict:
    by_name = sorted(trace.device_time_by_name().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in by_name],
            "idle_gaps": [[n[:120], s] for n, s in trace.idle_gaps()[:10]]}


def result_line(cell: Cell, outcome: Outcome, checks: List[Check], trace_run: bool,
                device: str) -> dict:
    """The contract's result line; ``checks`` comes last."""
    import torch

    metrics = {}
    if trace_run:
        run = Run(cell, outcome)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(outcome.end_to_end, setup_s=outcome.setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"the driver gave no {m['name']} for {cell.name}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": bool(checks) and all(c.ok for c in checks) and outcome.failed == 0,
            "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": metrics, "device": dev}
    if trace_run and outcome.trace is not None:
        dev["busy_s"] = outcome.trace.busy_s
        dev["window_s"] = outcome.trace.window_s
        line["breakdown"] = breakdown(outcome.trace)
    if device == "cuda":
        dev["card"] = power_limit()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line


def run_cell(ctx: Context) -> Optional[dict]:
    """Set up, measure, free the program, check, and build the line (None
    on the ranks but 0 of a multi-process cell)."""
    outcome = ctx.cell.driver().run(ctx)
    if outcome is None:
        return None
    if not outcome.memory_peak_bytes:
        outcome.memory_peak_bytes = memory_peak_bytes(ctx.device)
    gc.collect()
    if ctx.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    checks = outcome.check()
    return result_line(ctx.cell, outcome, checks, ctx.trace, ctx.device)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(line: dict) -> None:
    """The checks on standard error, as its last lines, then the line."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


# the wall-clock start of the process a multi-process cell was started as,
# for its ranks' set-up time
START_ENV = "MANIPOSE_BENCH_START"


def launch_ranks(argv, ranks: int, t_start: float) -> int:
    """Run this cell as ``ranks`` processes, one a card, under torchrun;
    rank 0 prints the line. Waits for every rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), str(BENCH_DIR / "run.py"), *argv]
    env = dict(os.environ, **{START_ENV: repr(time.time() - (time.perf_counter() - t_start))})
    try:
        return subprocess.run(cmd, timeout=3000, env=env).returncode
    except subprocess.TimeoutExpired:
        return 124


def main(argv, t_start: float) -> int:
    args = parse(argv)
    for key, path in cache_dirs(ROOT).items():
        os.environ.setdefault(key, path)
    use_bytecode_cache()
    cell = Cell.find(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    ranks = int(cell.mix.get("ranks", 1))
    if ranks > 1 and "LOCAL_RANK" not in os.environ:
        return launch_ranks(argv, ranks, t_start)
    if START_ENV in os.environ:  # a rank: set-up counts from the first process's start
        t_start = time.perf_counter() - (time.time() - float(os.environ[START_ENV]))
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    print(f"[{time.perf_counter() - t_start:8.2f} s] torch imported, {cell.name} found",
          file=sys.stderr, flush=True)
    if ranks > 1:
        ctx.rank, ctx.world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    try:
        line = run_cell(ctx)
    except Exception:  # the run failed: no result line
        traceback.print_exc()
        return 1
    if ctx.rank != 0:  # the other ranks of a multi-process cell print nothing
        return 0
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    emit(line)
    return 0
