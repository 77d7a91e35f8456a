"""Cost function base (counterpart of control_toolkit_tpu/costs/base.py).

The reduction semantics the optimizers rely on are the reference's:

* ``get_stage_cost`` shifts the raw stage cost by ``-MAX_COST``;
* ``get_trajectory_cost`` is the **mean** over H stage costs and one
  terminal cost, i.e. over H+1 entries;
* the control-change term ``ccrc_weight * sum((u_h - u_{h-1})^2)`` is
  seeded with the applied previous control.

Subclasses implement the struct-of-arrays primitives (component tuples);
the array forms, the fused loop and the kernels' plain versions derive
from them.  Tunable weights and attributes arrive in ``params`` as float32
tensors, so a changed weight or target reaches the next step unchanged
code.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch


class CostFunction:
    MAX_COST = 0.0

    # Numeric config entries that ride in params["cost"].
    dynamic_config_keys: tuple = ()
    # Environment attributes (params["attrs"]) this cost reads, and their
    # defaults when the host never set them — the single source for both
    # the dict path and the packed-parameter (kernel) path.
    attr_keys: tuple = ()
    attr_defaults: dict = {}
    # Extra terminal cost evaluated outside the rollout kernels on the
    # terminal states their emit_terminal forms write (a learned value
    # terminal, costs/value_terminal.py); None for a plain cost.
    post_terminal_cost = None

    def __init__(self, config: Optional[Dict] = None):
        self.config: Dict = dict(config or {})
        self.batch_size: Optional[int] = None
        self.horizon: Optional[int] = None

    def configure(self, batch_size: int, horizon: int, **kwargs) -> None:
        self.batch_size = batch_size
        self.horizon = horizon

    # Cost-config keys that mirror dynamics constants (masses and lengths
    # for energy shaping, link lengths for a tip height).  configure seeds
    # the ones the user did not set from the predictor and warns where an
    # explicit value disagrees: the cost must not score a mechanism other
    # than the one the rollouts simulate.
    mirrored_dynamics_keys: Tuple[str, ...] = ()

    def _init_merged(self, config: Optional[Dict]) -> Dict:
        """DEFAULTS merged with ``config``, recording which keys the user
        set (``sync_with_dynamics`` seeds the others)."""
        merged = dict(getattr(self, "DEFAULTS", {}))
        merged.update(config or {})
        self._explicit_keys = set(config or {})
        return merged

    def sync_with_dynamics(self, dyn_params: Dict) -> None:
        """Reconcile the cost's copies of dynamics constants with the
        predictor's parameters (``MPCController.configure`` calls it once
        both exist): keys of ``mirrored_dynamics_keys`` that the user did
        not set are seeded from the dynamics; an explicit value that
        differs is kept, with a warning.  A residual predictor's constants
        are its base's (``dyn_params["base"]``)."""
        if not self.mirrored_dynamics_keys or not isinstance(dyn_params, dict):
            return
        if isinstance(dyn_params.get("base"), dict):
            dyn_params = dyn_params["base"]
        logger = logging.getLogger(type(self).__module__)
        explicit = getattr(self, "_explicit_keys", set())
        for k in self.mirrored_dynamics_keys:
            if k not in dyn_params:
                continue
            dyn_v = float(dyn_params[k])
            if k in explicit:
                if abs(float(self.config[k]) - dyn_v) > 1e-9:
                    logger.warning(
                        f"{type(self).__name__}: cost {k}={self.config[k]} differs from the "
                        f"dynamics {k}={dyn_v}: the cost will score a different mechanism "
                        "than the rollouts simulate"
                    )
            else:
                self.config[k] = dyn_v

    # ---- struct-of-arrays primitives ---------------------------------------
    def _stage_cost_core_soa(self, xs, us, params) -> torch.Tensor:
        """Component-form stage cost sans control-change term."""
        raise NotImplementedError

    def control_change_cost_soa(self, us, prev_us, params) -> torch.Tensor:
        """``ccrc_weight * sum((u - prev)^2)`` when the cost declares a
        ``ccrc_weight``, else zero."""
        w = params["cost"].get("ccrc_weight")
        if w is None:
            return torch.zeros_like(us[0])
        return w * sum((u - pu) ** 2 for u, pu in zip(us, prev_us))

    def terminal_cost_soa(self, xs, params) -> torch.Tensor:
        return torch.zeros_like(xs[0])

    def kernel_terminal_soa(self, xs, params) -> torch.Tensor:
        """Terminal cost evaluated inside the rollout kernels."""
        return self.terminal_cost_soa(xs, params)

    # ---- array-of-structs forms (derived) ----------------------------------
    def _stage_cost_core(self, states, inputs, params) -> torch.Tensor:
        xs = tuple(states[..., i] for i in range(states.shape[-1]))
        us = tuple(inputs[..., j] for j in range(inputs.shape[-1]))
        return self._stage_cost_core_soa(xs, us, params)

    def control_change_cost(self, inputs, prev_inputs, params) -> torch.Tensor:
        us = tuple(inputs[..., j] for j in range(inputs.shape[-1]))
        pus = tuple(prev_inputs[..., j] for j in range(prev_inputs.shape[-1]))
        return self.control_change_cost_soa(us, pus, params)

    @property
    def supports_fused_rollout(self) -> bool:
        return type(self)._get_stage_cost is CostFunction._get_stage_cost

    def _get_stage_cost(self, states, inputs, previous_input, params) -> torch.Tensor:
        """[B,H,S],[B,H,U],prev_u,params -> [B,H]; the control-change term
        compares each input with its predecessor along the horizon, seeded
        with the applied previous control."""
        cost = self._stage_cost_core(states, inputs, params)
        if previous_input is not None:
            U = inputs.shape[-1]
            prev = torch.as_tensor(previous_input, dtype=inputs.dtype, device=inputs.device)
            if prev.ndim == 3 and prev.shape[1] == 1:
                prev = prev[:, 0, :]
            if prev.ndim == 2:
                prev = prev[:, None, :].expand(inputs[:, :1, :].shape)
            else:
                if prev.numel() != U:
                    raise ValueError(
                        f"previous_input must be [U], [B,U] or [B,1,U]; got "
                        f"shape {tuple(prev.shape)} for U={U}"
                    )
                prev = prev.reshape(-1).expand(inputs[:, :1, :].shape)
            shifted = torch.cat([prev, inputs[:, :-1, :]], dim=1)
            cost = cost + self.control_change_cost(inputs, shifted, params)
        return cost

    def stage_cost_step(self, x, u, u_prev, params) -> torch.Tensor:
        """Single-step stage cost for the fused rollout: [B,S],[B,U],[B,U]
        -> [B] (includes the MAX_COST shift)."""
        cost = self._stage_cost_core(x, u, params)
        if u_prev is not None:
            cost = cost + self.control_change_cost(u, u_prev, params)
        return cost - self.MAX_COST

    def get_terminal_cost(self, terminal_states, params) -> torch.Tensor:
        xs = tuple(terminal_states[..., i] for i in range(terminal_states.shape[-1]))
        return self.terminal_cost_soa(xs, params)

    def get_stage_cost(self, states, inputs, previous_input, params) -> torch.Tensor:
        return self._get_stage_cost(states, inputs, previous_input, params) - self.MAX_COST

    def get_trajectory_cost(self, state_horizon, inputs, previous_input=None,
                            params=None) -> torch.Tensor:
        """[B,H+1,S],[B,H,U] -> [B]: mean over (H stage costs + terminal)."""
        params = params if params is not None else self.current_params()
        stage = self.get_stage_cost(state_horizon[:, :-1, :], inputs, previous_input, params)
        terminal = self.get_terminal_cost(state_horizon[:, -1, :], params)
        total = torch.cat([stage, terminal[:, None]], dim=1)
        return torch.mean(total, dim=1)

    # ---- parameter plumbing ------------------------------------------------
    def current_params(self, attrs: Optional[Dict] = None,
                       device: Optional[torch.device] = None) -> Dict:
        """The params tree from the current config: float32 tensors on
        ``device`` (the CPU when None)."""
        cost = {
            k: torch.tensor(float(self.config[k]), dtype=torch.float32, device=device)
            for k in self.dynamic_config_keys
            if k in self.config
        }
        return {"cost": cost, "attrs": dict(attrs or {})}

    def reload_cost_parameters_from_config(self) -> None:
        """Hook invoked after the config dict was hot-reloaded."""
