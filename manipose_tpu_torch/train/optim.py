"""Optimizer and learning-rate schedules.

Port of ``manipose_tpu/train/optim.py``:
- ``torch.optim.Adam(weight_decay=w)`` couples the decay into the gradient
  before the moment updates, as optax's ``add_decayed_weights`` followed
  by ``scale_by_adam`` does (not AdamW);
- ``grad_clip`` follows ``optax.clip_by_global_norm``: the gradients are
  scaled by max / |g| only when |g| >= max, with no epsilon on the norm;
- ``skip_nonfinite`` follows ``optax.apply_if_finite``: a step whose
  gradients hold a NaN or an infinity leaves the parameters, the Adam
  moments and Adam's step count untouched;
- the learning rate is written into the param groups on every step, by
  schedules that run on the host (stepped once per validation epoch, as
  in the reference).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


class Optimizer:
    """torch-semantics Adam with a per-step learning rate, global-norm
    clipping and the non-finite-step guard of the JAX package.

    ``skip_nonfinite`` reads one flag back from the device per step (the
    decision to skip is taken on the host); the other paths never wait on
    the device.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 weight_decay: float = 1e-6, grad_clip: float = 0.0,
                 skip_nonfinite: bool = False):
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.notfinite_count = 0  # steps skipped so far

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def _grads(self):
        return [p.grad for p in self.params if p.grad is not None]

    def clip(self, grads) -> None:
        """optax.clip_by_global_norm, in place: g / |g| * max where
        |g| >= max."""
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip))

    def step(self, lr: float) -> bool:
        """Apply the accumulated gradients at learning rate ``lr``.
        Returns False when ``skip_nonfinite`` skipped the step."""
        grads = self._grads()
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            if not bool(finite):
                self.notfinite_count += 1
                return False
        if self.grad_clip > 0.0:
            self.clip(grads)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        return True


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   weight_decay: float = 1e-6, grad_clip: float = 0.0,
                   skip_nonfinite: bool = False) -> Optimizer:
    """Adam whose learning rate is given at every step (the schedules run
    on the host). ``grad_clip > 0`` clips by global norm; ``skip_nonfinite``
    skips a step whose gradients are not all finite."""
    return Optimizer(params, weight_decay, grad_clip, skip_nonfinite)


def lr_decay(step: int, lr: float, decay_step: int, gamma: float) -> float:
    """Exponential step decay."""
    return lr * gamma ** (step / decay_step)


class CosineAnnealingLR:
    """torch ``CosineAnnealingLR`` (closed form), stepped per validation
    epoch."""

    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        self.base_lr = base_lr
        self.t_max = t_max
        self.eta_min = eta_min
        self._step = 0

    @property
    def lr(self) -> float:
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self._step / self.t_max))
            / 2
        )

    def step(self, metric: Optional[float] = None) -> None:
        self._step += 1

    def state_dict(self):
        return {"step": self._step}

    def load_state_dict(self, state):
        self._step = state["step"]


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau(mode=min, threshold_mode=rel)``."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 11,
                 threshold: float = 0.1, min_lr: float = 0.0):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad_epochs = 0

    def step(self, metric: float) -> None:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]


def make_scheduler(kind: str, base_lr: float, epochs: int = 200,
                   n_annealing: int = 1, lr_min: float = 0.0,
                   lr_patience: int = 11, lr_threshold: float = 0.1):
    """"cosine" or "plateau", with the reference's settings."""
    if kind == "cosine":
        return CosineAnnealingLR(base_lr, t_max=epochs // n_annealing,
                                 eta_min=lr_min)
    if kind == "plateau":
        return ReduceLROnPlateau(base_lr, factor=0.5, patience=lr_patience,
                                 threshold=lr_threshold, min_lr=lr_min)
    raise ValueError(
        f"Accepted lr_scheduler values are 'cosine' and 'plateau'. Got {kind}."
    )
