"""Toy datasets: sample once into fixed train/val/test arrays
(``toy_experiment/data/datasets.py``).

The port's own copy of ``manipose_tpu/toy/datasets.py`` (numpy only; the
port imports nothing of the JAX package): the same seeds give the same
arrays."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class LiftingDataset:
    """1D -> 2D circle dataset (``datasets.py:11-59``)."""

    def __init__(self, distribution, n_train: int, n_val: int, n_test: int):
        self.distribution = distribution

        def prep(n):
            x, y = distribution.sample(n)
            return x[:, None].astype(np.float32), y.astype(np.float32)

        self.x_train, self.y_train = prep(n_train)
        self.x_val, self.y_val = prep(n_val)
        self.x_test, self.y_test = prep(n_test)

    @property
    def train(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.x_train, self.y_train

    @property
    def val(self):
        return self.x_val, self.y_val

    @property
    def test(self):
        return self.x_test, self.y_test


class LiftingDatasetV2(LiftingDataset):
    """2D -> 3D torus dataset (``datasets.py:62-119``): inputs already 2D."""

    def __init__(self, distribution, n_train: int, n_val: int, n_test: int):
        self.distribution = distribution

        def prep(n):
            x, y = distribution.sample(n)
            return x.astype(np.float32), y.astype(np.float32)

        self.x_train, self.y_train = prep(n_train)
        self.x_val, self.y_val = prep(n_val)
        self.x_test, self.y_test = prep(n_test)
