"""Deferred-binding cost function wrapper (counterpart of
control_toolkit_tpu/costs/wrapper.py).

Resolves a cost by ``(environment_name, cost_function_specification)``
through the port's registry, binds the hot-reload watcher and proxies the
cost API.  Without an explicit ``cost_config`` the weights come from
``config_cost_function.yml`` (ASF dir, else the packaged defaults,
``utils/config.py``) and the file is watched for hot reload
(``costs/updater.py``).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.costs.updater import CostFunctionUpdater
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.config import (
    CONFIG_COST_FUNCTION, load_cost_config, resolve_config_path,
)

logger = logging.getLogger(__name__)


class CostFunctionWrapper:
    def __init__(self):
        self.cost_function: Optional[CostFunction] = None
        self.cost_function_name: Optional[str] = None
        self.environment_name: Optional[str] = None
        self._updater = None

    def configure(
        self,
        batch_size: int,
        horizon: int,
        environment_name: str = "cartpole",
        cost_function_specification: Optional[str] = None,
        variable_parameters=None,
        watch_config: bool = True,
        cost_config: Optional[Dict] = None,
        **kwargs,
    ) -> None:
        """``cost_config`` gives the cost's weights directly: no file is
        read and none is watched."""
        if cost_config is None:
            try:
                full_cfg = load_cost_config()
            except FileNotFoundError:
                full_cfg = {}
        else:
            full_cfg, watch_config = {}, False
        name = (cost_function_specification or self.cost_function_name
                or full_cfg.get("cost_function_name_default", "default"))
        if cost_config is None:
            env_cfg = full_cfg.get(environment_name, {}) or {}
            cost_config = dict(env_cfg.get(name, {}) or {})

        registry._load_builtins()
        key = f"{environment_name}/{name}"
        if key in registry.cost_functions:
            cls = registry.cost_functions.get(key)
        elif name in registry.cost_functions:
            cls = registry.cost_functions.get(name)
        else:
            raise KeyError(
                f"No cost function {name!r} for environment {environment_name!r} "
                f"(tried {key!r}); available: {list(registry.cost_functions.names())}"
            )

        self.cost_function = cls(cost_config)
        self.cost_function.reload_cost_parameters_from_config_flag = False
        self.cost_function.configure(batch_size=batch_size, horizon=horizon)
        self.cost_function_name = name
        self.environment_name = environment_name

        if watch_config:
            try:
                path = resolve_config_path(CONFIG_COST_FUNCTION)
            except FileNotFoundError:
                logger.debug("no cost config file found; hot-reload disabled")
            else:
                self._updater = CostFunctionUpdater.ensure_watching(
                    self.cost_function, environment_name, name, path
                )

    def update_cost_parameters_from_config(self) -> bool:
        """Consume the hot-reload flag; returns True if params changed."""
        cf = self.cost_function
        if cf is not None and getattr(cf, "reload_cost_parameters_from_config_flag", False):
            cf.reload_cost_parameters_from_config_flag = False
            cf.reload_cost_parameters_from_config()
            return True
        return False

    # ---- proxied cost API ---------------------------------------------------
    def get_stage_cost(self, states, inputs, previous_input, params=None):
        return self.cost_function.get_stage_cost(
            states, inputs, previous_input,
            params if params is not None else self.cost_function.current_params(),
        )

    def get_terminal_cost(self, terminal_states, params=None):
        return self.cost_function.get_terminal_cost(
            terminal_states,
            params if params is not None else self.cost_function.current_params(),
        )

    def get_trajectory_cost(self, state_horizon, inputs, previous_input=None, params=None):
        return self.cost_function.get_trajectory_cost(state_horizon, inputs, previous_input, params)

    def current_params(self, attrs: Optional[Dict] = None, device=None) -> Dict:
        return self.cost_function.current_params(attrs, device)
