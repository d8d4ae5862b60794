from .common import (
    create_loader,
    get_subjects_and_actions,
    init_model_params,
    instantiate_model,
    torch_default_init,
)

__all__ = [
    "create_loader",
    "get_subjects_and_actions",
    "init_model_params",
    "instantiate_model",
    "torch_default_init",
]
