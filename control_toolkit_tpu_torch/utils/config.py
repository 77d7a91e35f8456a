"""YAML config files (counterpart of control_toolkit_tpu/utils/config.py).

The three-file contract of the reference's ``Control_Toolkit_ASF`` folder
(config_controllers.yml, config_optimizers.yml, config_cost_function.yml):
a file is taken from the ASF directory (``set_asf_config_dir``, else
``$CONTROL_TOOLKIT_ASF_DIR``, else ``./Control_Toolkit_ASF``) and falls
back to the package's own defaults in ``config_defaults/``, a copy of the
JAX package's.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

_PACKAGED_CONFIG_DIR = Path(__file__).resolve().parent.parent / "config_defaults"

CONFIG_CONTROLLERS = "config_controllers.yml"
CONFIG_OPTIMIZERS = "config_optimizers.yml"
CONFIG_COST_FUNCTION = "config_cost_function.yml"

_asf_dir_override: Optional[Path] = None


def set_asf_config_dir(path: os.PathLike | str | None) -> None:
    """Point the port at an application's Control_Toolkit_ASF directory."""
    global _asf_dir_override
    _asf_dir_override = Path(path) if path is not None else None


def get_asf_config_dir() -> Optional[Path]:
    if _asf_dir_override is not None:
        return _asf_dir_override
    env = os.environ.get("CONTROL_TOOLKIT_ASF_DIR")
    if env:
        return Path(env)
    cwd_asf = Path.cwd() / "Control_Toolkit_ASF"
    return cwd_asf if cwd_asf.is_dir() else None


def resolve_config_path(filename: str) -> Path:
    """The ASF directory's file, else the packaged default."""
    asf = get_asf_config_dir()
    if asf is not None and (asf / filename).is_file():
        return asf / filename
    packaged = _PACKAGED_CONFIG_DIR / filename
    if packaged.is_file():
        return packaged
    raise FileNotFoundError(
        f"Config file {filename!r} not found in ASF dir ({asf}) or packaged defaults"
    )


def load_yaml(path: os.PathLike | str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def load_config(filename: str) -> Dict[str, Any]:
    return load_yaml(resolve_config_path(filename))


def _entry(filename: str, name: str) -> Dict[str, Any]:
    cfg = load_config(filename)
    if name not in cfg:
        raise KeyError(f"{name!r} has no entry in {filename}")
    return dict(cfg[name])


def load_controller_config(controller_name: str) -> Dict[str, Any]:
    return _entry(CONFIG_CONTROLLERS, controller_name)


def load_optimizer_config(optimizer_name: str) -> Dict[str, Any]:
    return _entry(CONFIG_OPTIMIZERS, optimizer_name)


def load_cost_config() -> Dict[str, Any]:
    return load_config(CONFIG_COST_FUNCTION)
