from .losses import LossConfig, compute_loss
from .optim import (
    CosineAnnealingLR,
    Optimizer,
    ReduceLROnPlateau,
    lr_decay,
    make_optimizer,
    make_scheduler,
)
from .step import TrainState, make_eval_loss_step, make_train_step

__all__ = [
    "LossConfig",
    "compute_loss",
    "CosineAnnealingLR",
    "Optimizer",
    "ReduceLROnPlateau",
    "lr_decay",
    "make_optimizer",
    "make_scheduler",
    "TrainState",
    "make_eval_loss_step",
    "make_train_step",
]
