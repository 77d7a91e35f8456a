"""Learned terminal value as a cost wrapper (counterpart of
control_toolkit_tpu/costs/value_terminal.py).

``ValueTerminalCost(base, value_params, value_scale)`` adds ``scale *
V(x_H)`` to any cost's terminal cost, V a tanh MLP (``models/networks.py:
mlp_apply``) from the state to one cost-to-go: the MBVE / TD-MPC recipe,
a short horizon with the foresight of a long one.

The kernels keep the value terminal:

* the cost kernels (K1, K2, K4 over the ODE; K11, K12, K13, K14 over the
  learned models, and their session-row and member-block forms) evaluate
  the base's terminal in their body and emit the terminal states ``x_H
  [K, S]`` (their ``emit_terminal`` forms); the optimizer adds
  ``post_terminal_cost(x_H) / (H+1)``, V as ``torch.matmul``s outside the
  kernel;
* the gradient kernels (K7 over the ODE; K8, K9, K10 over the MLP,
  ``"ODE+res"``, the GP, and their session-row and member-block forms)
  take a plain ``w*/b*`` tanh MLP V in their forward (their ``value_spec``
  forms) and seed the adjoint with ``dV/dx_H``
  (``Optimizer._value_grad_spec``).

Every plant carries the ODE's and ``"ODE+res"``'s forms; the network
forms carry cartpole's cost alone, their gates raising
``NotImplementedError`` naming the form and the plant (``ops/kernels.py``
KERNEL_PLANTS).  The net's tensors ride in ``params["cost"]["_value_net"]``
and the scale in ``params["cost"]["_value_scale"]``, so
``update_value_params`` swaps a re-fit in with no rebuild.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.models.networks import mlp_apply
from control_toolkit_tpu_torch.utils.device import place


class ValueTerminalCost(CostFunction):
    """``base`` with ``terminal_cost = base_terminal + scale * V(x)``.

    Every cost surface delegates to ``base``, the struct-of-arrays
    primitives and the array forms alike, so a base that overrides
    ``_get_stage_cost`` or ``get_terminal_cost`` keeps its behaviour."""

    def __init__(self, base: CostFunction, value_params: Dict, value_scale: float = 1.0):
        if isinstance(base, ValueTerminalCost):
            raise ValueError(
                "refusing to nest ValueTerminalCost wrappers (V would apply twice); use "
                "attach_value_terminal, which updates an existing wrapper in place")
        self.base = base
        self.value_params = value_params
        self.value_scale = float(value_scale)
        # The base's config dict itself, so a hot reload reaches both.
        self.config = base.config
        self.attr_defaults = dict(getattr(base, "attr_defaults", {}))
        self.dynamic_config_keys = tuple(getattr(base, "dynamic_config_keys", ()))
        self.attr_keys = tuple(getattr(base, "attr_keys", ()))
        self.MAX_COST = base.MAX_COST
        self.batch_size = base.batch_size
        self.horizon = base.horizon

    def __getattr__(self, name):
        # Only for names the wrapper lacks: a base's extras delegate.
        base = self.__dict__.get("base")
        if base is None:
            raise AttributeError(name)
        return getattr(base, name)

    # The hot-reload watcher raises the flag on the base it registered
    # before the wrap; the CostFunctionWrapper reads and clears it here.
    @property
    def reload_cost_parameters_from_config_flag(self) -> bool:
        return getattr(self.base, "reload_cost_parameters_from_config_flag", False)

    @reload_cost_parameters_from_config_flag.setter
    def reload_cost_parameters_from_config_flag(self, v: bool) -> None:
        self.base.reload_cost_parameters_from_config_flag = v

    # ---- the value term ----------------------------------------------------
    def _value(self, x: torch.Tensor, params) -> torch.Tensor:
        """Scaled V of stacked states: ``[..., S] -> [...]``."""
        v = mlp_apply(params["cost"]["_value_net"], x)[..., 0]
        return params["cost"]["_value_scale"] * v

    # ---- lifecycle ---------------------------------------------------------
    def configure(self, batch_size: int, horizon: int, **kwargs) -> None:
        self.base.configure(batch_size=batch_size, horizon=horizon, **kwargs)
        self.batch_size = batch_size
        self.horizon = horizon

    def sync_with_dynamics(self, dyn_params: Dict) -> None:
        sync = getattr(self.base, "sync_with_dynamics", None)
        if sync is not None:
            sync(dyn_params)

    def reload_cost_parameters_from_config(self) -> None:
        self.base.reload_cost_parameters_from_config()

    # ---- struct-of-arrays primitives -----------------------------------------
    def _stage_cost_core_soa(self, xs, us, params):
        return self.base._stage_cost_core_soa(xs, us, params)

    def control_change_cost_soa(self, us, prev_us, params):
        return self.base.control_change_cost_soa(us, prev_us, params)

    def terminal_cost_soa(self, xs, params):
        return self.base.terminal_cost_soa(xs, params) + self._value(torch.stack(xs, dim=-1),
                                                                     params)

    def kernel_terminal_soa(self, xs, params):
        # The part evaluated inside the kernels; V joins outside them
        # (post_terminal_cost) or in K7's value_spec form.
        return self.base.kernel_terminal_soa(xs, params)

    def post_terminal_cost(self, x_term: torch.Tensor, params) -> torch.Tensor:
        """``[K, S]`` terminal states emitted by a kernel -> ``[K]``: V, plus
        the base's own hook if it has one."""
        base_post = getattr(self.base, "post_terminal_cost", None)
        v = self._value(x_term, params)
        return v if base_post is None else v + base_post(x_term, params)

    # ---- array-of-structs forms (a base may override these) -------------------
    def _get_stage_cost(self, states, inputs, previous_input, params):
        return self.base._get_stage_cost(states, inputs, previous_input, params)

    def get_stage_cost(self, states, inputs, previous_input, params):
        return self.base.get_stage_cost(states, inputs, previous_input, params)

    def stage_cost_step(self, x, u, u_prev, params):
        return self.base.stage_cost_step(x, u, u_prev, params)

    def get_summed_stage_cost(self, state_horizon, inputs, previous_input=None, params=None):
        return self.base.get_summed_stage_cost(state_horizon, inputs, previous_input, params)

    def get_terminal_cost(self, terminal_states, params):
        return (self.base.get_terminal_cost(terminal_states, params)
                + self._value(terminal_states, params))

    @property
    def supports_fused_rollout(self) -> bool:
        return self.base.supports_fused_rollout

    def current_params(self, attrs: Optional[Dict] = None,
                       device: Optional[torch.device] = None) -> Dict:
        """The base's params with ``_value_net`` (the net's tensors on
        ``device``) and ``_value_scale`` (a 0-d tensor) in ``cost``."""
        p = self.base.current_params(attrs, device)
        p["cost"] = dict(p["cost"])
        p["cost"]["_value_net"] = place(self.value_params, device or torch.device("cpu"))
        p["cost"]["_value_scale"] = torch.tensor(self.value_scale, dtype=torch.float32,
                                                 device=device)
        return p


def attach_value_terminal(ctrl, value_params: Dict, value_scale: float = 1.0
                          ) -> ValueTerminalCost:
    """Wrap an ``mpc`` (or ``batched-mpc``) controller's cost with a learned
    terminal value, in place, and return the wrapper.  The optimizer's step
    is built again (its kernels change to their value forms) and the
    controller's cost params are placed again.  On a controller already
    wrapped, the wrapper is updated in place instead of nested.  A hook on
    the controller (``_cost_wrap_hook``) wraps the cost again with the live
    net whenever ``configure`` rebuilds it."""
    wrapper = ctrl.cost_function
    inner = getattr(wrapper, "cost_function", None)
    if inner is None:
        raise ValueError("attach_value_terminal expects a controller whose cost_function is a "
                         f"CostFunctionWrapper (mpc); got {type(wrapper).__name__}")
    # The live value state: the hook and update_value_params read and
    # write this dict, so a later configure wraps with the current net.
    holder = getattr(ctrl, "_value_holder", None)
    if holder is None:
        holder = ctrl._value_holder = {}
    holder["params"] = value_params
    holder["scale"] = float(value_scale)

    def hook(inner_cost):
        h = ctrl._value_holder
        if isinstance(inner_cost, ValueTerminalCost):
            inner_cost.value_params, inner_cost.value_scale = h["params"], h["scale"]
            return inner_cost
        return ValueTerminalCost(inner_cost, h["params"], h["scale"])

    ctrl._cost_wrap_hook = hook

    if isinstance(inner, ValueTerminalCost):
        inner.value_params, inner.value_scale = value_params, float(value_scale)
        ctrl._cost_params = None
        return inner
    if getattr(ctrl, "num_slots", 0):
        # The batched step was built against the bare cost: configure again
        # from the stashed call (the hook wraps the new cost); slot states
        # start over, the objective having changed.
        stash_args, stash_kwargs = ctrl._configure_stash
        ctrl.configure(*stash_args, **stash_kwargs)
        return ctrl.cost_function.cost_function
    vt = ValueTerminalCost(inner, value_params, value_scale)
    wrapper.cost_function = vt
    ctrl._cost_params = None
    ctrl.optimizer._build()
    return vt


def update_value_params(ctrl, value_params: Dict) -> None:
    """Swap a re-fit value net into a wrapped controller: the next step
    reads the new tensors; nothing is rebuilt."""
    cf = getattr(ctrl.cost_function, "cost_function", None)
    if not isinstance(cf, ValueTerminalCost):
        raise ValueError("controller's cost is not a ValueTerminalCost; call "
                         "attach_value_terminal first")
    cf.value_params = value_params
    h = getattr(ctrl, "_value_holder", None)
    if h is not None:
        h["params"] = value_params
    ctrl._cost_params = None
