"""Logging helpers: CSV tables, metric averaging.

Port of ``manipose_tpu/utils/logging.py`` (``save_csv_log``,
``AverageMeter``, ``MetricLogger``), written with the ``csv`` module: the
files are those pandas writes there (minimal quoting, ``\\n`` line ends, no
index column). MLflow is not ported: ``MetricLogger(mlflow_on=True)``
raises.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def save_csv_log(
    output_dir,
    head,
    value: np.ndarray,
    is_create: bool = False,
    file_name: str = "test",
) -> str:
    """Write (``is_create`` or a new file: with the header ``head``) or
    append the rows of ``value`` to ``<output_dir>/<file_name>.csv``."""
    value = np.asarray(value)
    if value.ndim < 2:
        value = np.expand_dims(value, axis=0)
    file_path = os.path.join(str(output_dir), f"{file_name}.csv")
    create = is_create or not os.path.exists(file_path)
    with open(file_path, "w" if create else "a", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if create:
            writer.writerow(head)
        writer.writerows(value.tolist())
    return file_path


class MetricLogger:
    """Metric sink: an in-memory history, saved as a CSV on request."""

    def __init__(self, mlflow_on: bool = False):
        if mlflow_on:
            raise NotImplementedError(
                "MLflow logging (run.mlflow_on=true) is not ported; the "
                "metrics are kept in MetricLogger.history"
            )
        self.history = []

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self.history.append({"step": step, **metrics})

    def save_csv(self, output_dir, file_name: str = "metrics") -> Optional[str]:
        """The history as a CSV: one column per metric, in the order first
        seen, empty where a row has no value."""
        if not self.history:
            return None
        columns = list(dict.fromkeys(k for row in self.history for k in row))
        path = os.path.join(str(output_dir), f"{file_name}.csv")
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, columns, restval="", lineterminator="\n")
            writer.writeheader()
            writer.writerows(self.history)
        return path
