"""The toy Table 1 and Table 6 runs: 5 seeds x {mlp, constrained,
constrained_rmcl} through the port's ``toy.main``.

The port's copy of ``scripts/quantitative_comparison_toy2d.sh`` (Table 1:
the hard-2 circle scenario, with the reference's per-arch train presets
``mlp_hard2``, ``constrained_hard2`` and ``rmcl_constrained_hard2``) and
``scripts/quantitative_comparison_toy3d.sh`` (Table 6: the torus 2D->3D
scenario with the ``3D_setup`` data and train presets), with the same
``run.experiment`` names, ``toy2d_<arch>_seed<N>`` and
``toy3d_<arch>_seed<N>``. Overrides after the setting go to every run, as
the scripts pass theirs on; ``--seeds`` cuts the seed list. The runs'
directories are what ``tools.get_table_data`` aggregates into the tables.
The runs train on the card unless ``device=cpu`` is among the overrides.

  python -m manipose_tpu_torch.tools.quantitative_comparison --setting toy2d \\
      [--seeds 42,43] [run.output_dir=outputs_toy device=cpu ...]
"""

from __future__ import annotations

import argparse

SEEDS = (42, 43, 44, 45, 46)
ARCHS = ("mlp", "constrained", "constrained_rmcl")
# the reference's per-arch train presets of the hard-2 circle scenario
TOY2D_PRESETS = {"mlp": "mlp_hard2", "constrained": "constrained_hard2",
                 "constrained_rmcl": "rmcl_constrained_hard2"}


def runs(setting: str, seeds=SEEDS, extra=()) -> list:
    """[(run.experiment, the run's overrides)] in the scripts' order (seed,
    then arch)."""
    out = []
    for seed in seeds:
        for arch in ARCHS:
            if setting == "toy2d":
                overrides = ["data.scenario=hard-2", f"model.arch={arch}",
                             f"train={TOY2D_PRESETS[arch]}"]
            elif setting == "toy3d":
                overrides = ["data=3D_setup", "train=3D_setup", f"model.arch={arch}"]
            else:
                raise ValueError(f"unknown setting {setting!r}: toy2d or toy3d")
            name = f"{setting}_{arch}_seed{seed}"
            out.append((name, [*overrides, f"run.seed={seed}",
                               f"run.experiment={name}", *extra]))
    return out


def main(argv=None) -> list:
    """Run every run of the setting; return [(run.experiment, validation
    MPJPE)]."""
    from ..config import load_config
    from ..toy.main import main as toy_main

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--setting", choices=["toy2d", "toy3d"], required=True)
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)),
                    help="comma-separated seeds (default 42,43,44,45,46)")
    ap.add_argument("overrides", nargs="*", help="key=value, passed to every run")
    args = ap.parse_args(argv)
    results = []
    seeds = [int(s) for s in args.seeds.split(",")]
    for name, overrides in runs(args.setting, seeds, args.overrides):
        results.append((name, toy_main(load_config("toy", overrides))))
    return results


if __name__ == "__main__":
    main()
