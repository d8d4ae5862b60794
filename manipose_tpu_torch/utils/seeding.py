"""Deterministic seeding helpers.

Port of ``manipose_tpu/utils/seeding.py``. The reference seeds
python/numpy/torch and sets cuDNN/CUBLAS determinism knobs
(``hpe/mh_so3_hpe/utils.py:50-120``). The port, like the JAX package,
passes its randomness through explicit generators (a ``torch.Generator``
for drop-path, ``np.random.Generator`` streams for the data), so this
module only centralizes their derivation and sets no determinism knob.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
import torch


def set_random_seeds(seed: int) -> Tuple[torch.Generator, np.random.Generator]:
    """Seed the ambient python and numpy state and derive the canonical
    (torch generator, numpy generator) pair: where the JAX package returns
    ``jax.random.PRNGKey(seed)``, the port returns a CPU
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(int(seed)), np.random.default_rng(seed)


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """Per-epoch host data stream (replaces torch's ``seed_worker``,
    ``utils.py:117-120``); the JAX package's stream, bit for bit."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch]))
