"""Config system: YAML groups + hydra-style ``key=value`` CLI overrides.

The port's own copy of ``manipose_tpu/config/core.py`` (the port imports
nothing of the JAX package); it reads the same ``configs/*.yaml``.

The reference uses Hydra (``hpe/main_h36m_lifting.py:711``,
``hpe/conf/*.yaml``). Hydra is not a dependency, so this is a small
equivalent that keeps the README command surface intact:
``python scripts/main_h36m.py train.batch_size=25 model.arch=mixste``
and group swaps via ``data=mpi_inf_3dhp`` / ``train=mix_ste`` behave like
the reference's config groups.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Optional, Sequence

import yaml

CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"


class Config(dict):
    """Attribute-accessible nested dict."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def to_yaml(self) -> str:
        return yaml.safe_dump(_plain(self), sort_keys=False)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _wrap(x):
    if isinstance(x, dict):
        return Config({k: _wrap(v) for k, v in x.items()})
    return x


_BARE_EXP_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_value(text: str) -> Any:
    """YAML-parse a scalar override value ('5' -> int, 'true' -> bool...).

    YAML 1.1 leaves bare-exponent floats like '1e-3' as strings (it
    requires '1.0e-3'); hydra/OmegaConf parse them as floats, and the
    reference README uses that form — match it."""
    value = yaml.safe_load(text)
    if isinstance(value, str) and _BARE_EXP_FLOAT.match(value):
        return float(value)
    return value


def _deep_update(base: dict, patch: dict) -> dict:
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _set_path(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    cur = cfg
    for k in keys[:-1]:
        if k not in cur or not isinstance(cur[k], dict):
            cur[k] = {}
        cur = cur[k]
    cur[keys[-1]] = value


def load_config(
    name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    config_root: Optional[Path] = None,
) -> Config:
    """Load ``configs/<name>.yaml`` and apply overrides.

    Override forms:
      - ``group=file``  (when ``configs/<name>/<group>/<file>.yaml`` or
        ``configs/<group>/<file>.yaml`` exists; the config-specific dir
        wins — the reference keeps separate hydra group trees per entry
        point, ``hpe/conf`` vs ``toy_experiment/conf``): merge that
        group file into the ``group`` section.
      - ``a.b.c=value``: set a single leaf.

    A leading ``+`` on the key (hydra's append syntax, used by the
    reference sweep scripts) is accepted and ignored.
    """
    root = Path(config_root) if config_root else CONFIG_ROOT
    with open(root / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f) or {}

    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got: {item}")
        key, value = item.split("=", 1)
        key = key.lstrip("+")
        group_file = root / name / key / f"{value}.yaml"
        if not group_file.exists():
            group_file = root / key / f"{value}.yaml"
        if "." not in key and group_file.exists():
            with open(group_file) as f:
                patch = yaml.safe_load(f) or {}
            _deep_update(cfg.setdefault(key, {}), patch)
        else:
            _set_path(cfg, key, _parse_value(value))
    return _wrap(cfg)
