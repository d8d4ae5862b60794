from .core import CONFIG_ROOT, Config, config_from_dict, load_config

__all__ = ["CONFIG_ROOT", "Config", "config_from_dict", "load_config"]
