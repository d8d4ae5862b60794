from .common import instantiate_model, torch_default_init

__all__ = ["instantiate_model", "torch_default_init"]
