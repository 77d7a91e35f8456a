"""Cost-parameter hot reload (counterpart of
control_toolkit_tpu/costs/updater.py).

A daemon thread polls the cost YAML's mtime; on a change it re-reads the
file, updates the config of every live cost bound to that (file,
environment, cost name) and raises each one's
``reload_cost_parameters_from_config_flag``, which the control loop
consumes at its next step.  The new weights are tensors the next step
reads, so a reload never rebuilds anything.
"""
from __future__ import annotations

import atexit
import logging
import threading
import weakref
from pathlib import Path
from typing import Dict, Optional

import yaml

logger = logging.getLogger(__name__)

_watchers: Dict[str, "CostFunctionUpdater"] = {}
_watchers_lock = threading.Lock()


class CostFunctionUpdater:
    """Polls one YAML file; on change, updates the bound cost functions."""

    POLL_INTERVAL_S = 0.25

    def __init__(self, cost_function, environment_name: str, cost_function_name: str,
                 config_path: Path):
        # Weak references: each configure() binds a fresh cost and nothing
        # unbinds it, so strong ones would keep dead controllers' costs alive.
        self._cost_refs = [weakref.ref(cost_function)]
        self.environment_name = environment_name
        self.cost_function_name = cost_function_name
        self.config_path = Path(config_path)
        self._mtime = self._stat_mtime()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"cost-updater-{self.config_path.name}", daemon=True
        )
        self._thread.start()

    @property
    def cost_functions(self):
        """The live bound costs; dead references are dropped."""
        self._cost_refs = [r for r in self._cost_refs if r() is not None]
        return [cf for cf in (r() for r in self._cost_refs) if cf is not None]

    @classmethod
    def ensure_watching(cls, cost_function, environment_name, cost_function_name,
                        config_path) -> "CostFunctionUpdater":
        """One watcher per (path, environment, cost name); a new cost joins it."""
        key = f"{config_path}::{environment_name}::{cost_function_name}"
        with _watchers_lock:
            if key not in _watchers:
                _watchers[key] = cls(cost_function, environment_name, cost_function_name,
                                     Path(config_path))
            elif not any(cf is cost_function for cf in _watchers[key].cost_functions):
                _watchers[key]._cost_refs.append(weakref.ref(cost_function))
            return _watchers[key]

    def _stat_mtime(self) -> Optional[float]:
        try:
            return self.config_path.stat().st_mtime
        except OSError:
            return None

    def _run(self) -> None:
        while not self._stop.wait(self.POLL_INTERVAL_S):
            mtime = self._stat_mtime()
            if mtime is not None and mtime != self._mtime:
                self._mtime = mtime
                self._reload()

    def _reload(self) -> None:
        try:
            with open(self.config_path) as f:
                full = yaml.safe_load(f) or {}
            env_cfg = full.get(self.environment_name, {}) or {}
            new_cfg = env_cfg.get(self.cost_function_name, {}) or {}
        except Exception as e:  # a half-written file: its next write reloads
            logger.warning(f"cost config reload failed ({e}); keeping old params")
            return
        for cf in self.cost_functions:
            cf.config.update(new_cfg)
            cf.reload_cost_parameters_from_config_flag = True
        logger.info(f"hot-reloaded cost parameters from {self.config_path}")

    def stop(self) -> None:
        self._stop.set()


@atexit.register
def _cleanup() -> None:
    with _watchers_lock:
        for w in _watchers.values():
            w.stop()
        _watchers.clear()
