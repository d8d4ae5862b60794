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

Each traffic driver (``traffic/<driver>.py``) carries its own as
``control(ctx, kind)``. Prints one JSON line a seed with each compared
number. The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:1] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

from harness import core  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", choices=("tf32", "half_batch", "no_exchange"), required=True)
    args = ap.parse_args()
    cell = core.Cell.find(args.workload)
    control = cell.driver().control
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = core.Context(cell, seed, 0.0, False, "cuda", t0)
        numbers = control(ctx, args.kind)
        limits = cell.mix["limits"]
        print(json.dumps({"workload": cell.name, "kind": args.kind, "seed": seed,
                          "numbers": numbers, "limits": {k: limits.get(k) for k in numbers},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
