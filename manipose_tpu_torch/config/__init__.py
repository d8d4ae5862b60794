from .core import CONFIG_ROOT, Config, load_config

__all__ = ["CONFIG_ROOT", "Config", "load_config"]
