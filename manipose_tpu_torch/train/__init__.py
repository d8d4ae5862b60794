from .init import flax_default_init, torch_default_init
from .losses import LossConfig, compute_loss
from .optim import (
    CosineAnnealingLR,
    Optimizer,
    ReduceLROnPlateau,
    lr_decay,
    make_optimizer,
    make_scheduler,
    optimizer_from_config,
)
from .step import (
    MultiTrainStep,
    TrainState,
    make_eval_loss_step,
    make_multi_train_step,
    make_train_step,
)

__all__ = [
    "flax_default_init",
    "torch_default_init",
    "LossConfig",
    "compute_loss",
    "CosineAnnealingLR",
    "Optimizer",
    "ReduceLROnPlateau",
    "lr_decay",
    "make_optimizer",
    "make_scheduler",
    "optimizer_from_config",
    "MultiTrainStep",
    "TrainState",
    "make_eval_loss_step",
    "make_multi_train_step",
    "make_train_step",
]
