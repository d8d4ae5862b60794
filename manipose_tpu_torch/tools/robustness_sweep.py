"""Occlusion-robustness sweep: eval a checkpoint across keypoint-miss
patterns and rates.

The port's copy of ``tools/robustness_sweep.py``, on the card
(``device=cpu`` among the overrides for the CPU). The reference exposes
its 5 input-corruption patterns only one config at a time
(``data.miss_type``/``miss_rate``,
``hpe/mh_so3_hpe/data/generators.py:162-214``; conf
``hpe/conf/config.yaml:55-57``); this tool sweeps the grid on the test
split and tables MPJPE (+oracle for rMCL) per (miss_type, miss_rate) —
the paper's robustness-to-occlusion question as one command.

``noisy`` ignores ``miss_rate`` in the reference semantics
(``generators.py:208-211`` draws N(0, noise_sigma) regardless), so it
is swept over ``--noise-sigmas`` instead of the rate grid. NOTE the
units: the reference adds N(0, sigma) directly to the NORMALIZED
([-1, 1]-scale) 2D coordinates, so its default sigma=5 is near-total
input corruption; sigmas of ~0.01-0.05 probe realistic detector noise.

  python -m manipose_tpu_torch.tools.robustness_sweep --checkpoint ckpt.pth \\
      --miss-types random structured_joint structured_frame noisy \\
      --miss-rates 0.1 0.2 0.4 --noise-sigmas 5 15 --out sweep.csv \\
      data.data_dir=/path/to/h36m [overrides...]

``--checkpoint`` takes a reference ``.pth`` or a run directory of the
port with ``--tag`` (``Predictor.from_any``; the JAX package's orbax
directories are refused); without it the seeded init is swept.
``--dataset 3dhp`` runs the grid through the MPI-INF-3DHP test split
instead (``data=mpi_inf_3dhp`` is implied) and adds the protocol's
PCK@150/AUC columns (oracle-based for rMCL, as in
``hpe/main_3dhp.py:882-910``).
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np
import torch

MISS_TYPES = (
    "no_miss", "random", "random_left_arm_right_leg", "structured_joint",
    "structured_frame", "noisy",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default="",
                    help=".pth (reference format) or a run directory of the port")
    ap.add_argument("--tag", default="best_val")
    ap.add_argument("--dataset", choices=["h36m", "3dhp"], default="h36m")
    ap.add_argument("--miss-types", nargs="+", default=["random", "noisy"],
                    choices=MISS_TYPES)
    ap.add_argument("--miss-rates", nargs="+", type=float,
                    default=[0.1, 0.2, 0.4])
    ap.add_argument("--noise-sigmas", nargs="+", type=float, default=[5.0],
                    help="noise stds in NORMALIZED screen units for the "
                    "'noisy' type (which "
                    "ignores miss_rate, as in the reference)")
    ap.add_argument("--out", type=Path, default=None,
                    help="CSV output path (also prints a JSON summary)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..eval.engine import EvalConfig, evaluate
    from ..serving import Predictor

    base_overrides = list(args.overrides)
    if args.dataset == "3dhp":
        base_overrides = ["data=mpi_inf_3dhp"] + base_overrides
    cfg = load_config("config", overrides=base_overrides)

    if args.dataset == "3dhp":
        from ..data.dhp3 import Dataset3DHP
        from ..drivers.dhp3 import create_loader as make_loader_3dhp

        dataset = Dataset3DHP(cfg.data.data_dir, train=False)
        skeleton = dataset.skeleton

        def make_loader(sweep_cfg):
            return make_loader_3dhp(dataset, sweep_cfg, train=False)

    else:
        from ..drivers.common import create_loader, get_subjects_and_actions
        from ..drivers.h36m import fetch_and_prepare_data

        keypoints, dataset = fetch_and_prepare_data(cfg)
        (_, _, s_test), action_filter = get_subjects_and_actions(dataset, cfg)
        skeleton = dataset.skeleton

        def make_loader(sweep_cfg):
            return create_loader(
                keypoints, dataset, action_filter, s_test, sweep_cfg,
                train=False,
            )

    # one loader for every checkpoint kind (.pth, run directory, none)
    loaded = Predictor.from_any(args.checkpoint, tag=args.tag, cfg=cfg,
                                skeleton=skeleton,
                                device=cfg.get("device", "cuda"))
    model, rmcl = loaded.model, loaded.rmcl

    eval_cfg = EvalConfig(tta=cfg.train.tta, rmcl=rmcl, compute_oracle=rmcl)

    grid = [("no_miss", 0.0, 0.0)]
    for t in args.miss_types:
        if t == "no_miss":
            continue
        if t == "noisy":
            grid += [("noisy", 0.0, s) for s in args.noise_sigmas]
        else:
            grid += [(t, r, 0.0) for r in args.miss_rates]
    rows = []
    for miss_type, rate, sigma in grid:
        sweep_cfg = load_config(
            "config",
            overrides=base_overrides
            + [f"data.miss_type={miss_type}", f"data.miss_rate={rate}"]
            + ([f"data.noise_sigma={sigma}"] if miss_type == "noisy" else []),
        )
        loader = make_loader(sweep_cfg)
        results = evaluate(model, loader, skeleton, eval_cfg)
        row = {
            "miss_type": miss_type,
            "miss_rate": rate,
            "noise_sigma": sigma,
            "mpjpe_mm": round(float(results[2]), 3),
        }
        if rmcl:
            row["oracle_mpjpe_mm"] = round(float(results[3]), 3)
            row["ps_oracle_mpjpe_mm"] = round(float(results[4]), 3)
        if args.dataset == "3dhp":
            # PCK@150/AUC on the oracle poses for rMCL (the protocol's
            # headline, ``hpe/main_3dhp.py:882-910``) + the aggregated
            # ones; on the plain predictions otherwise.
            from ..metrics import keypoint_3d_auc, keypoint_3d_pck

            tgt = torch.from_numpy(
                np.concatenate(results[1], axis=0) * 1000.0
            ).reshape(-1, skeleton.num_joints, 3)

            def _pck_auc(pred_list):
                p = torch.from_numpy(np.concatenate(pred_list, axis=0)).reshape(
                    -1, skeleton.num_joints, 3
                )
                return (
                    float(keypoint_3d_pck(p, tgt, mask=None, threshold=150.0)),
                    float(keypoint_3d_auc(p, tgt, mask=None)),
                )

            if rmcl:
                row["pck"], row["auc"] = (
                    round(v, 3) for v in _pck_auc(results[5])
                )
                agg_pck, agg_auc = _pck_auc(results[0])
                row["agg_pck"] = round(agg_pck, 3)
                row["agg_auc"] = round(agg_auc, 3)
            else:
                row["pck"], row["auc"] = (
                    round(v, 3) for v in _pck_auc(results[0])
                )
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {args.out}")
    clean = rows[0]["mpjpe_mm"]
    worst = max(r["mpjpe_mm"] for r in rows)
    print(json.dumps({
        "clean_mpjpe_mm": clean,
        "worst_mpjpe_mm": worst,
        "max_degradation_mm": round(worst - clean, 3),
        "n_settings": len(rows),
    }))
    return rows


if __name__ == "__main__":
    main()
