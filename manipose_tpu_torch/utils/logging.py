"""Logging helpers: CSV tables, metric averaging.

Port of ``manipose_tpu/utils/logging.py`` (``save_csv_log``,
``AverageMeter``, ``MetricLogger``), written with the ``csv`` module: the
files are those pandas writes there (minimal quoting, ``\\n`` line ends, no
index column). MLflow is optional, as there: ``MetricLogger(mlflow_on=True)``
sends the metrics to MLflow as well when ``mlflow`` imports, and otherwise
keeps them in its history alone, with ``mlflow_on`` read back False.
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
    """Metric sink: an in-memory history, saved as a CSV on request, and
    MLflow (experiment ``experiment``, at ``tracking_uri`` when given) with
    ``mlflow_on`` where it imports."""

    def __init__(self, mlflow_on: bool = False, experiment: str = "default",
                 tracking_uri: Optional[str] = None):
        self.history = []
        self.mlflow_on = mlflow_on
        self._mlf = None
        if mlflow_on:
            try:
                import mlflow

                if tracking_uri:
                    mlflow.set_tracking_uri(tracking_uri)
                mlflow.set_experiment(experiment)
                self._mlf = mlflow
            except Exception:  # not installed, or no tracking server
                self.mlflow_on = False

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self.history.append({"step": step, **metrics})
        if self._mlf is not None:
            try:
                self._mlf.log_metrics(
                    {k: float(v) for k, v in metrics.items()}, step=step
                )
            except Exception:  # a non-numeric value, or the server went away
                pass

    def log_params(self, params: Dict[str, object]) -> None:
        """Send run parameters to MLflow; without it, nothing."""
        if self._mlf is not None:
            try:
                self._mlf.log_params(params)
            except Exception:
                pass

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
