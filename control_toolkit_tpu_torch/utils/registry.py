"""Name-based component registries (counterpart of
control_toolkit_tpu/utils/registry.py).

The port keeps the JAX package's registered names (``"mpc"``, ``"mppi"``,
``"ODE"``, ``"cartpole/default"``, ...) in its OWN registry instances, so
the two packages can be imported side by side without their names
colliding, and ``_load_builtins`` imports only the port's modules.
"""
from __future__ import annotations

import importlib
import logging
from typing import Callable, Dict, List

logger = logging.getLogger(__name__)


class Registry:
    """A name->class registry (the JAX package's ASF-override tier has no
    user in the port yet)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._classes: Dict[str, type] = {}

    def register(self, name: str) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            if name in self._classes:
                raise ValueError(f"Duplicate {self.kind} registration for name {name!r}")
            self._classes[name] = cls
            cls.registered_name = name
            return cls
        return deco

    def get(self, name: str) -> type:
        if name not in self._classes:
            raise KeyError(f"No {self.kind} named {name!r}. Available: {self.names()}")
        return self._classes[name]

    def __contains__(self, name: str) -> bool:
        return name in self._classes

    def names(self) -> List[str]:
        return sorted(self._classes)


controllers = Registry("controller")
optimizers = Registry("optimizer")
cost_functions = Registry("cost_function")
predictors = Registry("predictor")
environments = Registry("environment")

_BUILTIN_MODULES = (
    "control_toolkit_tpu_torch.optimizers.mppi",
    "control_toolkit_tpu_torch.optimizers.rpgd",
    "control_toolkit_tpu_torch.optimizers.gradient",
    "control_toolkit_tpu_torch.optimizers.cem",
    "control_toolkit_tpu_torch.optimizers.icem",
    "control_toolkit_tpu_torch.optimizers.random_action",
    "control_toolkit_tpu_torch.optimizers.cem_gmm",
    "control_toolkit_tpu_torch.optimizers.cma_es",
    "control_toolkit_tpu_torch.optimizers.mppi_var",
    "control_toolkit_tpu_torch.optimizers.cem_naive_grad",
    "control_toolkit_tpu_torch.optimizers.cem_grad_bharadhwaj",
    "control_toolkit_tpu_torch.controllers.mpc",
    "control_toolkit_tpu_torch.controllers.batched_mpc",
    "control_toolkit_tpu_torch.costs.cartpole",
    "control_toolkit_tpu_torch.costs.pendulum",
    "control_toolkit_tpu_torch.costs.acrobot",
    "control_toolkit_tpu_torch.costs.pointmass",
    "control_toolkit_tpu_torch.models.predictors",
    "control_toolkit_tpu_torch.models.neural_predictor",
    "control_toolkit_tpu_torch.models.residual_predictor",
    "control_toolkit_tpu_torch.models.gp_predictor",
    "control_toolkit_tpu_torch.models.ensemble_predictor",
    "control_toolkit_tpu_torch.environments.cartpole",
    "control_toolkit_tpu_torch.environments.pendulum",
    "control_toolkit_tpu_torch.environments.acrobot",
    "control_toolkit_tpu_torch.environments.pointmass",
)


def _load_builtins() -> None:
    """Import the port's built-in component modules so their
    registrations run (an import error propagates: every module listed
    here ships with the package)."""
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def import_controller_by_name(name: str):
    """Resolve a controller class by name; an optimizer name resolves to
    the ``"mpc"`` controller (reference sugar)."""
    _load_builtins()
    if name in controllers:
        return controllers.get(name)
    if name in optimizers:
        logger.info(f"{name!r} is an optimizer; resolving to the 'mpc' controller.")
        return controllers.get("mpc")
    raise KeyError(f"No controller or optimizer named {name!r}")


def import_optimizer_by_name(name: str):
    _load_builtins()
    return optimizers.get(name)
