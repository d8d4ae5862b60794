"""Hyper-parameter search over driver objectives (TPE by default).

The port's copy of ``tools/hp_search.py``. The reference wires
hydra-optuna-sweeper and returns ``best_valid_mpjpe`` from ``main`` as the
objective (``hpe/main_h36m_lifting.py:1264-1266``). optuna is not a
dependency, so the same capability is implemented natively: a TPE sampler
(``manipose_tpu_torch/utils/tpe.py``) with JSONL sweep persistence/resume
and a best-trial report. ``--sampler random`` recovers plain random
search. Each trial runs the driver's ``main`` (``toy.main``,
``drivers.h36m.main`` or ``drivers.dhp3.main``) on the card; put
``device=cpu`` after ``--`` for the CPU.

  python -m manipose_tpu_torch.tools.hp_search --driver toy --trials 12 \\
      --sampler tpe --journal /tmp/sweep.jsonl \\
      --space train.lr=loguniform:1e-4,1e-2 model.hidden_features=choice:16,32,64 \\
      -- data.scenario=hard-2 model.arch=constrained_rmcl train.epochs=30
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import load_config
from ..utils.tpe import RandomSampler, TPESampler, parse_space, run_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--driver", choices=["h36m", "3dhp", "toy"], default="toy")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", choices=["tpe", "random"], default="tpe")
    ap.add_argument("--journal", type=Path, default=None,
                    help="JSONL sweep state; resumes if it exists")
    ap.add_argument("--space", nargs="+", required=True)
    ap.add_argument("rest", nargs="*")
    args = ap.parse_args(argv)

    if args.driver == "toy":
        from ..toy.main import main as run

        base_cfg = "toy"
    elif args.driver == "h36m":
        from ..drivers.h36m import main as run

        base_cfg = "config"
    else:
        from ..drivers.dhp3 import main as run

        base_cfg = "config"

    space = parse_space(args.space)
    sampler_cls = TPESampler if args.sampler == "tpe" else RandomSampler
    sampler = sampler_cls(space, seed=args.seed)

    def objective(params, trial):
        overrides = list(args.rest)
        overrides += [f"{k}={v}" for k, v in params.items()]
        overrides += [f"run.experiment=hp_trial_{trial}"]
        cfg = load_config(base_cfg, overrides=overrides)
        return run(cfg)

    best_params, best_value, history = run_sweep(
        objective, space, args.trials, sampler=sampler, journal=args.journal
    )
    n_ok = sum(1 for _, y in history if y is not None)
    print(f"\nsweep report: {len(history)} trials ({n_ok} finished)")
    print(f"best objective: {best_value}")
    print(f"best params:    {best_params}")
    return best_params, best_value, history


if __name__ == "__main__":
    main()
