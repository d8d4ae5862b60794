"""Aggregate multi-seed experiment metrics into a results table
(reference: hpe/useful_aux_scripts/get_table2_data.py, which pulls MLflow
CSVs into LaTeX).

The port's copy of ``tools/get_table_data.py``. It reads ``metrics.txt``
and ``protocol_1_err.csv`` from experiment output dirs whose names end in
``_seed<N>``, groups them by the prefix, and prints mean±std markdown and
LaTeX rows (the toy Table 1/6 aggregation), byte for byte as the JAX tool
prints them. The CSV is read with the standard library, not pandas: the
last row, each column after the first, as pandas parses them.

  python -m manipose_tpu_torch.tools.get_table_data outputs_toy/*
"""

from __future__ import annotations

import csv
import re
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np


def read_metrics(d: Path) -> dict:
    metrics = {}
    mfile = d / "metrics.txt"
    if mfile.exists():
        for line in mfile.read_text().splitlines():
            parts = line.split(": ")
            if len(parts) != 2:
                continue  # blank / malformed line: skip, don't abort
            try:
                metrics[parts[0]] = float(parts[1])
            except ValueError:
                continue
    table = d / "protocol_1_err.csv"
    if table.exists():
        with open(table, newline="") as f:
            header, *rows = list(csv.reader(f))
        for col, value in zip(header[1:], rows[-1][1:]):
            metrics[col] = float(value)
    return metrics


def group_runs(dirs) -> dict:
    """{experiment name without ``_seed<N>``: [metrics of each seed's dir]};
    a dir may be ``experiment_seedN`` or hold it under ``default``."""
    groups = defaultdict(list)
    for d in map(Path, dirs):
        target = d / "default" if (d / "default").exists() else d
        m = read_metrics(target)
        if not m:
            continue
        groups[re.sub(r"_seed\d+$", "", d.name)].append(m)
    return groups


def table_lines(groups: dict) -> list:
    """The markdown table, a blank line and the LaTeX rows, as printed."""
    keys = sorted({k for ms in groups.values() for m in ms for k in m})
    lines = ["| experiment | n | " + " | ".join(keys) + " |",
             "|" + "---|" * (len(keys) + 2)]
    latex_rows = []
    for name, ms in sorted(groups.items()):
        cells = []
        for k in keys:
            vals = [m[k] for m in ms if k in m]
            cells.append(f"{np.mean(vals):.3f}±{np.std(vals):.3f}" if vals else "-")
        lines.append(f"| {name} | {len(ms)} | " + " | ".join(cells) + " |")
        latex_rows.append(name + " & " + " & ".join(cells) + r" \\")
    return lines + ["", "% LaTeX:", "\n".join(latex_rows)]


def main(argv=None) -> dict:
    """Print the table of the dirs ``argv`` (the command line's by
    default); return the groups."""
    dirs = sys.argv[1:] if argv is None else list(argv)
    if not dirs:
        raise SystemExit(__doc__)
    groups = group_runs(dirs)
    print("\n".join(table_lines(groups)))
    return groups


if __name__ == "__main__":
    main()
