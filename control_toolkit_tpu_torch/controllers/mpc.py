"""MPC controller: optimizer + predictor + cost function composition
(counterpart of control_toolkit_tpu/controllers/mpc.py).

The two-phase configure resolves the dependency chain (optimizer knows
K/H -> predictor needs K/dt -> predictor knows state dims -> optimizer
needs dims); a step runs hot-reload check -> update_attributes ->
optimizer.step -> update_logs.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from control_toolkit_tpu_torch.controllers.base import Controller
from control_toolkit_tpu_torch.costs.wrapper import CostFunctionWrapper
from control_toolkit_tpu_torch.models.predictors import PredictorWrapper
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.config import load_optimizer_config
from control_toolkit_tpu_torch.utils.device import place

logger = logging.getLogger(__name__)


def _scalars(tree) -> bool:
    """A dict of scalar constants (numbers, 0-d arrays), compared by value."""
    return isinstance(tree, dict) and all(
        not isinstance(v, (dict, tuple, list)) and np.ndim(v) == 0 for v in tree.values())


@registry.controllers.register("mpc")
class MPCController(Controller):
    _has_optimizer = True

    def configure(
        self,
        optimizer_name: Optional[str] = None,
        predictor_specification: Optional[str] = None,
        optimizer_config: Optional[Dict] = None,
        mesh=None,
        predictor_config: Optional[Dict] = None,
        cost_function_config: Optional[Dict] = None,
    ) -> None:
        """``predictor_config`` forwards extra kwargs to the predictor;
        ``cost_function_config`` gives the cost's weights directly instead
        of reading (and watching) ``config_cost_function.yml``."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported to control_toolkit_tpu_torch yet (ROADMAP)"
            )
        if not optimizer_name:
            optimizer_name = str(self.config_controller["optimizer"])
        if not predictor_specification:
            predictor_specification = self.config_controller.get("predictor_specification", "ODE")
        if optimizer_config is None:
            optimizer_config = load_optimizer_config(optimizer_name)
        config_optimizer = dict(optimizer_config)

        self.cost_function = CostFunctionWrapper()
        self.predictor = PredictorWrapper()

        OptimizerCls = registry.import_optimizer_by_name(optimizer_name)
        self.optimizer = OptimizerCls(
            predictor=self.predictor,
            cost_function=self.cost_function,
            control_limits=self.control_limits,
            optimizer_logging=self.controller_logging,
            logging_lazy=self.logging_lazy,
            calculate_optimal_trajectory=self.config_controller.get(
                "calculate_optimal_trajectory", False
            ),
            **config_optimizer,
        )
        # The device must be known before optimizer.configure(): it decides
        # where the state, the interpolation matrix and the noise live.
        self.optimizer.device = self.device

        dt = config_optimizer.get("mpc_timestep", 0.02)
        self.predictor.configure(
            batch_size=self.optimizer.num_rollouts,
            horizon=self.optimizer.mpc_horizon,
            dt=dt,
            predictor_specification=predictor_specification,
            environment_name=self.environment_name,
            variable_parameters=self.variable_parameters,
            device=self.device,
            **(predictor_config or {}),
        )
        self.cost_function.configure(
            batch_size=self.optimizer.num_rollouts,
            horizon=self.optimizer.mpc_horizon,
            environment_name=self.environment_name,
            cost_function_specification=self.config_controller.get(
                "cost_function_specification", None
            ),
            variable_parameters=self.variable_parameters,
            cost_config=cost_function_config,
        )
        # A persistent cost transform (attach_value_terminal's) wraps the
        # cost this configure built, so a re-configure keeps it.
        if getattr(self, "_cost_wrap_hook", None) is not None:
            self.cost_function.cost_function = self._cost_wrap_hook(
                self.cost_function.cost_function)
        # Costs that mirror dynamics constants (the pendulum's m, L and g,
        # the acrobot's link lengths) reconcile with the predictor's before
        # the step is built.
        self.cost_function.cost_function.sync_with_dynamics(self.predictor.default_params())
        self.optimizer.configure(
            dt=dt,
            predictor_specification=predictor_specification,
            num_states=self.predictor.num_states,
            num_control_inputs=self.predictor.num_control_inputs,
        )
        self._dyn_raw = None
        self._dyn_params = None
        self._cost_params = None

    def _assemble_params(self) -> Dict:
        """The params tree for the optimizer step: tensors on the
        controller's device, cached until a dynamics value changes, the
        cost config hot-reloads, or an attribute is updated.

        ``dyn`` may nest.  Scalar constants (an ODE's, a residual
        predictor's ``base``) are cached and compared by value.  A tensor
        subtree (a learned net's ``net``, the residual's ``res``, the GP's
        ``gp``) is placed once and again only when the predictor's subtree
        object changes (a checkpoint swap, ``set_residual``, a GP re-fit).
        A recurrent net's ``hidden`` is handed through live, the very
        tensors that ``update`` advanced, with no copy."""
        fresh = self.predictor.default_params()
        if _scalars(fresh):
            if self._dyn_params is None or fresh != self._dyn_raw:
                self._dyn_params = self._place_scalars(fresh)
        else:
            raw, placed = self._dyn_raw or {}, self._dyn_params or {}
            dyn = {}
            for k, v in fresh.items():
                if k == "hidden":
                    dyn[k] = v
                elif k in placed and (v == raw[k] if _scalars(v) else v is raw[k]):
                    dyn[k] = placed[k]
                else:
                    dyn[k] = self._place_scalars(v) if _scalars(v) else place(v, self.device)
            self._dyn_params = dyn
        self._dyn_raw = fresh
        if self._cost_params is None:
            self._cost_params = self.cost_function.current_params(device=self.device)["cost"]
        return {
            "dyn": self._dyn_params,
            "cost": self._cost_params,
            "attrs": self.variable_parameters,
        }

    def _place_scalars(self, values: Dict) -> Dict:
        return {k: torch.tensor(float(v), dtype=torch.float32, device=self.device)
                for k, v in values.items()}

    def step(self, s: np.ndarray, time=None, updated_attributes: Optional[Dict] = None):
        if self.cost_function.update_cost_parameters_from_config():
            self._cost_params = None  # re-place the reloaded weights
        self.update_attributes(updated_attributes)
        u = self.optimizer.step(s, time, params=self._assemble_params())
        if self.controller_logging:
            # The stage cost actually incurred by the applied control.
            self.optimizer.logging_values["realized_cost_logged"] = self._realized_cost(s, u)
        self.update_logs(self.optimizer.logging_values)
        self.u = u
        return u

    def _realized_cost(self, s, u) -> np.ndarray:
        cf = self.cost_function.cost_function
        params = self._assemble_params()
        cp = {"cost": params["cost"], "attrs": params["attrs"]}

        def dev(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

        u_prev = dev(np.reshape(np.asarray(self.u if np.ndim(self.u) else [self.u]), (-1,)))
        out = cf.stage_cost_step(dev(s)[None], dev(u)[None], u_prev[None], cp)[0]
        return out.cpu().numpy()

    def controller_reset(self) -> None:
        self.optimizer.optimizer_reset()
        # The next episode's first realized cost must not use the last
        # episode's final control as u_prev.
        self.u = np.zeros_like(np.asarray(self.u))
