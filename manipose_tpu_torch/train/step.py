"""Train and eval-loss steps.

Port of ``manipose_tpu/train/step.py``: forward (trunks + FK decode), the
composite loss, backward and the torch-semantics Adam update, with the
learning rate given per step by host-side schedules. The step returns its
metrics as 0-dim device tensors and never waits on the device, so steps
queue back to back; the caller reads a metric when it logs it.

On the card the trunks' attention and MLPs run the port's kernels forward
(K1, K3, K5) and backward (K2, K4, K6); on the CPU their plain versions
run. Drop-path masks come from the state's generator on the model's
device, never from torch's global RNG.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..geometry.skeleton import Skeleton
from ..models.mix_ste import set_drop_path_generator
from .losses import LossConfig, compute_loss
from .optim import Optimizer

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the drop-path generator and the count of
    steps taken."""

    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer, seed: int = 0,
               device="cuda") -> "TrainState":
        """Move ``model`` to ``device`` (the card unless the caller asks
        for the CPU; its parameters stay the objects ``optimizer`` holds)
        and give its DropPath layers a generator there, seeded with
        ``seed``."""
        device = resolve_device(device)
        model.to(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        set_drop_path_generator(model, generator)
        return cls(model, optimizer, generator)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(
    model: nn.Module,
    loss_cfg: LossConfig,
    skeleton: Optional[Skeleton],
    optimizer: Optimizer,
    accum_steps: int = 1,
) -> Callable[..., Metrics]:
    """Build the train step for ``model`` and ``optimizer`` (those of the
    state it is given).

    Returns step(state, pose_2d, pose_3d, lr, n_valid=None) -> metrics.
    ``n_valid`` keeps only the leading rows (the de-duplicated part of a
    padded final batch). ``accum_steps > 1`` splits the batch into that
    many microbatches, sums their gradients and scales the sum by
    1/accum_steps before the one optimizer update, as the JAX step does; a
    batch that does not split evenly takes one single-shot gradient.
    """

    def loss_fn(pose_2d, pose_3d):
        return compute_loss(model(pose_2d), pose_3d, loss_cfg, skeleton)

    def accumulate_grads(pose_2d, pose_3d):
        b = pose_2d.shape[0]
        if accum_steps == 1 or b % accum_steps:
            total, terms = loss_fn(pose_2d, pose_3d)
            total.backward()
            return total.detach(), {k: v.detach() for k, v in terms.items()}
        micro = b // accum_steps
        total, terms = None, None
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            t, ts = loss_fn(pose_2d[rows], pose_3d[rows])
            t.backward()  # gradients sum over microbatches
            ts = {k: v.detach() for k, v in ts.items()}
            if total is None:
                total, terms = t.detach(), ts
            else:
                total = total + t.detach()
                terms = {k: terms[k] + v for k, v in ts.items()}
        inv = 1.0 / accum_steps
        for p in optimizer.params:
            if p.grad is not None:
                p.grad.mul_(inv)
        return total * inv, {k: v * inv for k, v in terms.items()}

    def step(state: TrainState, pose_2d, pose_3d, lr: float,
             n_valid: Optional[int] = None) -> Metrics:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer")
        device = _device(model)
        pose_2d = torch.as_tensor(pose_2d).to(device)
        pose_3d = torch.as_tensor(pose_3d).to(device)
        if n_valid is not None:
            pose_2d, pose_3d = pose_2d[:n_valid], pose_3d[:n_valid]
        model.train()
        optimizer.zero_grad()
        total, terms = accumulate_grads(pose_2d, pose_3d)
        optimizer.step(lr)
        state.step += 1
        return {"loss": total, **terms}

    return step


def make_eval_loss_step(
    model: nn.Module,
    loss_cfg: LossConfig,
    skeleton: Optional[Skeleton],
) -> Callable[..., Metrics]:
    """Validation-loss step: deterministic forward (``model.eval()``), no
    gradients. Returns step(pose_2d, pose_3d, n_valid=None) -> metrics,
    computed on the leading ``n_valid`` rows (the padded final batch's
    de-duplicated part)."""

    def step(pose_2d, pose_3d, n_valid: Optional[int] = None) -> Metrics:
        device = _device(model)
        pose_2d = torch.as_tensor(pose_2d).to(device)[:n_valid]
        pose_3d = torch.as_tensor(pose_3d).to(device)[:n_valid]
        model.eval()
        with torch.no_grad():
            total, terms = compute_loss(model(pose_2d), pose_3d, loss_cfg,
                                        skeleton)
        return {"loss": total, **terms}

    return step
