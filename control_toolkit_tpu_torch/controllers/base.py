"""Controller base class (counterpart of control_toolkit_tpu/controllers/base.py).

Per-controller config, control limits, environment attributes as named
float32 tensors, the 7-key logging contract (``get_outputs()`` stacks each
log along axis 0), ``update_attributes`` and the name property.  The
config's ``device`` key picks the ``torch.device`` the controller's
tensors live on (``utils/device.py``).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from control_toolkit_tpu_torch.utils.config import load_controller_config
from control_toolkit_tpu_torch.utils.device import resolve_device

SAVE_VARS = [
    "Q_logged",
    "J_logged",
    "s_logged",
    "u_logged",
    "realized_cost_logged",
    "trajectory_ages_logged",
    "rollout_trajectories_logged",
]


class Controller(ABC):
    _has_optimizer = False
    registered_name: str = "template"

    def __init__(
        self,
        environment_name: str,
        control_limits: Tuple[np.ndarray, np.ndarray],
        initial_environment_attributes: Optional[Dict] = None,
        config: Optional[Dict] = None,
    ):
        if config is not None:
            self.config_controller = dict(config)
        else:
            self.config_controller = load_controller_config(self.controller_name)

        self.environment_name = environment_name
        self.control_limits = control_limits
        self.action_low, self.action_high = control_limits
        self.device = resolve_device(self.config_controller.get("device"))

        # Named environment attributes (targets etc.), read by the cost
        # every step; updating one changes a value, never the program.
        self.variable_parameters: Dict[str, torch.Tensor] = {}
        self.update_attributes(initial_environment_attributes or {})

        self.u = 0.0
        self.controller_logging = bool(self.config_controller.get("controller_logging", False))
        # Lazy logging keeps per-step diagnostics as device tensors until
        # get_outputs()/flush_logs().
        self.logging_lazy = bool(self.config_controller.get("logging_lazy", False))
        self.save_vars = list(SAVE_VARS)
        self.logs: Dict[str, List] = {v: [] for v in self.save_vars}
        self.controller_data_for_csv: Dict = {}

    def configure(self, **kwargs) -> None:
        """Additional initialization; override in subclasses."""

    def update_attributes(self, updated_attributes: Optional[Dict]) -> None:
        if not updated_attributes:
            return
        for k, v in updated_attributes.items():
            self.variable_parameters[k] = torch.as_tensor(
                v, dtype=torch.float32, device=self.device
            )

    @abstractmethod
    def step(self, s: np.ndarray, time=None, updated_attributes: Optional[Dict] = None):
        ...

    def controller_report(self) -> None:
        """No report for this controller."""

    def controller_reset(self) -> None:
        raise NotImplementedError

    @property
    def controller_name(self) -> str:
        return self.registered_name

    @property
    def has_optimizer(self) -> bool:
        return self._has_optimizer

    def get_outputs(self) -> Dict[str, Optional[np.ndarray]]:
        """Stack per-step logs along axis 0."""
        self.flush_logs()
        return {
            name: np.stack(v, axis=0) if len(v) > 0 else None
            for name, v in self.logs.items()
        }

    def flush_logs(self) -> None:
        """Move device-resident log entries to host numpy arrays."""
        for name, v in self.logs.items():
            self.logs[name] = [
                x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x for x in v
            ]

    def update_logs(self, logging_values: Dict) -> None:
        if not self.controller_logging:
            return
        for name in self.save_vars:
            var = logging_values.get(name)
            if var is None:
                continue
            if isinstance(var, torch.Tensor):
                # Lazy: tensors are not mutated in place by the optimizer.
                self.logs[name].append(var if self.logging_lazy else var.detach().cpu().numpy())
            else:
                self.logs[name].append(np.asarray(var).copy())
