"""Toy trainer: epoch loop, per-model loss dispatch, early stopping.

Port of ``manipose_tpu/toy/trainer.py`` (the reference's
``toy_experiment/training/trainer.py``), with its semantics: MSE for
plain models (through the torus->joints map in the 3D scenario), WTA + BCE
for rMCL, diffusion's own loss; Adam without weight decay (the port's
``train.optim.Optimizer``); ``ReduceLROnPlateau`` stepped with the best
validation loss; batches shuffled by ``np.random.default_rng(seed)``, the
JAX package's order, and batches of fewer than 2 samples skipped
(BatchNorm); the best validation weights, BatchNorm statistics included,
put back after training.

The model and the data live on ``device`` (the card unless the caller asks
for the CPU); each epoch's losses are read once, at its end. Diffusion's
steps and noise come from a ``torch.Generator`` on the device seeded with
``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..train.optim import ReduceLROnPlateau, make_optimizer
from .models import (
    aggregate_toy_hypotheses,
    torus_points_to_joints,
    wta_with_scoring_l2_loss,
    wta_with_scoring_l2_loss_v2,
)


@dataclasses.dataclass
class ToyTrainerConfig:
    epochs: int = 200
    batch_size: int = 100
    lr: float = 1e-3
    lr_scheduler: bool = True
    lr_min: float = 0.0
    lr_patience: int = 10
    lr_threshold: float = 1e-4
    seed: int = 42


class ToyTrainer:
    """Generic toy trainer.

    model_kind: "plain" | "mcl" | "diffusion"; enabled_3d selects the
    torus joint-space loss wrapping (``trainer.py:83-90,104-110``).
    """

    def __init__(self, model, cfg: ToyTrainerConfig, model_kind: str = "plain",
                 enabled_3d: bool = False, joints_prediction: bool = True,
                 beta: float = 0.1, major_radius: float = 2.0,
                 minor_radius: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.model_kind = model_kind
        self.enabled_3d = enabled_3d
        self.joints_prediction = joints_prediction
        self.beta = beta
        self.major_radius = major_radius
        self.minor_radius = minor_radius
        self.loss_list = []
        self.val_loss_list = []
        self.optimizer = make_optimizer(model.parameters(), weight_decay=0.0)
        self.scheduler = (
            ReduceLROnPlateau(cfg.lr, factor=0.5, patience=cfg.lr_patience,
                              threshold=cfg.lr_threshold, min_lr=cfg.lr_min)
            if cfg.lr_scheduler else None
        )
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _supervised_loss(self, pred, y):
        """MSE; in 3D through the joints map (``trainer.py:83-90``)."""
        if not self.enabled_3d:
            return torch.mean((pred - y) ** 2)
        y1, y2 = torus_points_to_joints(y, self.major_radius, self.minor_radius)
        if self.joints_prediction:
            p1, p2 = pred[:, :3], pred[:, 3:]
        else:
            p1, p2 = torus_points_to_joints(pred, self.major_radius, self.minor_radius)
        return 0.5 * (torch.mean((p1 - y1) ** 2) + torch.mean((p2 - y2) ** 2))

    def _train_loss(self, x, y):
        if self.model_kind == "diffusion":
            return self.model.calc_loss(x, y, generator=self.generator)
        pred = self.model(x)
        if self.model_kind == "mcl":
            if self.enabled_3d:
                return wta_with_scoring_l2_loss_v2(pred, y, self.beta, self.major_radius,
                                                   self.minor_radius)
            return wta_with_scoring_l2_loss(pred, y, self.beta)
        return self._supervised_loss(pred, y)

    @torch.no_grad()
    def _eval_loss(self, x, y):
        """The supervised loss on the aggregated prediction, the reference's
        early-stopping criterion (``trainer.py:160-163``)."""
        self.model.eval()
        if self.model_kind == "diffusion":
            pred = self.model.sample_hypotheses(x, generator=self.generator).mean(dim=1)
        elif self.model_kind == "mcl":
            pred = aggregate_toy_hypotheses(self.model(x))
        else:
            pred = self.model(x)
        return self._supervised_loss(pred, y)

    def _snapshot(self):
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def train(self, train_data: Tuple[np.ndarray, np.ndarray],
              val_data: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        """Train; with ``val_data``, leave the best validation weights in the
        model. Returns the model's state dict."""
        x_train, y_train = (self._tensor(a) for a in train_data)
        if val_data is not None:
            x_val, y_val = (self._tensor(a) for a in val_data)
        n = x_train.shape[0]
        best_val, best = np.inf, self._snapshot()
        rng = np.random.default_rng(self.cfg.seed)
        for _ in range(self.cfg.epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            losses = []
            self.model.train()
            for start in range(0, n, self.cfg.batch_size):
                idx = order[start:start + self.cfg.batch_size]
                if len(idx) < 2:  # BatchNorm needs > 1 sample
                    continue
                lr = self.scheduler.lr if self.scheduler else self.cfg.lr
                self.optimizer.zero_grad()
                loss = self._train_loss(x_train[idx], y_train[idx])
                loss.backward()
                self.optimizer.step(lr)
                losses.append(loss.detach())
            self.loss_list.append(float(torch.stack(losses).double().mean()))
            if val_data is not None:
                val_loss = float(self._eval_loss(x_val, y_val))
                self.val_loss_list.append(val_loss)
                if val_loss < best_val:
                    best_val, best = val_loss, self._snapshot()
                if self.scheduler is not None:
                    self.scheduler.step(best_val)
        if val_data is not None:  # the best validation weights (trainer.py:196-201)
            self.model.load_state_dict(best)
        return self.model.state_dict()

    @torch.no_grad()
    def predict(self, x: np.ndarray, n_samples: Optional[int] = None) -> np.ndarray:
        """Forward in eval mode; hypotheses for mcl and diffusion."""
        self.model.eval()
        x = self._tensor(x)
        if self.model_kind == "diffusion":
            out = self.model.sample_hypotheses(x, n_samples, generator=self.generator)
        else:
            out = self.model(x)
        return out.cpu().numpy()

    def evaluate(self, eval_sets, metric: Callable, **metric_kwargs):
        """(``trainer.py:203-236``): aggregate hypotheses, then score.

        Returns (performances, aggregated predictions, hypotheses or None);
        metrics are computed on the aggregated predictions.
        """
        performances, predictions, hypotheses = [], [], []
        for x_eval, y_eval in eval_sets:
            out = self.predict(x_eval)
            if self.model_kind in ("mcl", "diffusion"):
                hypotheses.append(out)
                if self.model_kind == "diffusion":
                    preds = out.mean(axis=1)
                else:
                    preds = aggregate_toy_hypotheses(torch.from_numpy(out)).numpy()
            else:
                preds = out
            predictions.append(preds)
            try:
                perf = metric(preds, y_eval, **metric_kwargs)
            except TypeError:
                perf = metric(preds)
            performances.append(perf)
        return performances, predictions, hypotheses or None
