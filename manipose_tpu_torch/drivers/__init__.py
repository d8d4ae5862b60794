from . import common, dhp3, h36m
from .common import (
    create_loader,
    get_subjects_and_actions,
    init_model_params,
    instantiate_model,
    maybe_restore_eval_params,
)

__all__ = [
    "common",
    "dhp3",
    "h36m",
    "create_loader",
    "get_subjects_and_actions",
    "init_model_params",
    "instantiate_model",
    "maybe_restore_eval_params",
]
