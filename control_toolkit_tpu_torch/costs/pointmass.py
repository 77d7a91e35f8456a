"""Point-mass costs (counterpart of control_toolkit_tpu/costs/pointmass.py).

State [x, y, xD, yD]; two inputs.  ``target_x``/``target_y`` are
attributes (``params["attrs"]``), so the setpoint moves without a rebuild.
``pointmass/default`` and ``pointmass/obstacles`` implement the
struct-of-arrays primitives, which the kernels' plants evaluate
(``csrc/plants.cuh`` PointmassCost, PointmassObstacleCost);
``pointmass/trajectory`` overrides ``_get_stage_cost`` with array
attributes and keeps the scan path, as in the JAX package.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.costs import obstacles as obst
from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("pointmass/default")
@registry.cost_functions.register("pointmass/quadratic")
class PointMassQuadraticCost(CostFunction):
    dynamic_config_keys = (
        "pos_weight", "vel_weight", "cc_weight", "ccrc_weight", "R",
    )
    attr_keys = ("target_x", "target_y")
    attr_defaults = {"target_x": 0.0, "target_y": 0.0}

    DEFAULTS = {
        "pos_weight": 20.0,
        "vel_weight": 1.0,
        "cc_weight": 0.1,
        "ccrc_weight": 0.1,
        "R": 1.0,
    }

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.0)
        ty = attrs.get("target_y", 0.0)
        x, y, vx, vy = xs
        pos = w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2)
        vel = w["vel_weight"] * (vx**2 + vy**2)
        cc = w["cc_weight"] * w["R"] * sum(u * u for u in us)
        return pos + vel + cc

    def terminal_cost_soa(self, xs, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.0)
        ty = attrs.get("target_y", 0.0)
        x, y, vx, vy = xs
        return 10.0 * w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2) + (
            w["vel_weight"] * (vx**2 + vy**2)
        )

    def cost_components(self, states, inputs, previous_input=None, params=None):
        """Named stage-cost terms ``[...]`` of states ``[..., 4]`` and
        inputs ``[..., 2]``."""
        params = params if params is not None else self.current_params()
        w = params["cost"]
        tx = params["attrs"].get("target_x", 0.0)
        ty = params["attrs"].get("target_y", 0.0)
        return {
            "pos": w["pos_weight"] * ((states[..., 0] - tx) ** 2 + (states[..., 1] - ty) ** 2),
            "vel": w["vel_weight"] * (states[..., 2] ** 2 + states[..., 3] ** 2),
            "cc": w["cc_weight"] * w["R"] * torch.sum(inputs**2, dim=-1),
        }


@registry.cost_functions.register("pointmass/trajectory")
class PointMassTrajectoryCost(CostFunction):
    """Track a time-varying reference trajectory over the horizon.

    ``ref_x``/``ref_y`` are array attributes of shape [H+1] (the reference
    position at each rollout step, the terminal one included): stage h
    tracks ref[h], the terminal state ref[H].  The time index must reach
    the cost, so it overrides ``_get_stage_cost``, which leaves
    ``supports_fused_rollout`` false: the scan path alone, as in the JAX
    package.
    """

    dynamic_config_keys = ("pos_weight", "vel_weight", "cc_weight", "R")

    DEFAULTS = {
        "pos_weight": 20.0,
        "vel_weight": 0.2,
        "cc_weight": 0.1,
        "R": 1.0,
    }

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def configure(self, batch_size, horizon, **kwargs):
        super().configure(batch_size, horizon, **kwargs)
        # The defaults depend on the horizon: hold position at the origin.
        self.attr_keys = ("ref_x", "ref_y")
        self.attr_defaults = {
            "ref_x": torch.zeros((horizon + 1,), dtype=torch.float32),
            "ref_y": torch.zeros((horizon + 1,), dtype=torch.float32),
        }

    def _refs(self, params, H, device):
        attrs = params["attrs"]
        zeros = torch.zeros((H + 1,), dtype=torch.float32, device=device)
        ref_x = torch.as_tensor(attrs.get("ref_x", zeros), dtype=torch.float32, device=device)
        ref_y = torch.as_tensor(attrs.get("ref_y", zeros), dtype=torch.float32, device=device)
        return ref_x, ref_y

    def _get_stage_cost(self, states, inputs, previous_input, params):
        w = params["cost"]
        H = inputs.shape[1]
        ref_x, ref_y = self._refs(params, H, states.device)
        pos = w["pos_weight"] * (
            (states[..., 0] - ref_x[:H]) ** 2 + (states[..., 1] - ref_y[:H]) ** 2
        )
        vel = w["vel_weight"] * (states[..., 2] ** 2 + states[..., 3] ** 2)
        cc = w["cc_weight"] * w["R"] * torch.sum(inputs**2, dim=-1)
        return pos + vel + cc

    def get_terminal_cost(self, terminal_states, params):
        w = params["cost"]
        ref_x, ref_y = self._refs(params, self.horizon or 1, terminal_states.device)
        return 10.0 * w["pos_weight"] * (
            (terminal_states[..., 0] - ref_x[-1]) ** 2
            + (terminal_states[..., 1] - ref_y[-1]) ** 2
        )


@registry.cost_functions.register("pointmass/obstacles")
class PointMassObstacleCost(PointMassQuadraticCost):
    """Waypoint tracking through a field of circular obstacles
    (``costs/obstacles.py``: the penalty and its attribute layout)."""

    dynamic_config_keys = (
        PointMassQuadraticCost.dynamic_config_keys + obst.OBSTACLE_CONFIG_KEYS
    )
    attr_keys = PointMassQuadraticCost.attr_keys + obst.OBSTACLE_ATTR_KEYS
    attr_defaults = {**PointMassQuadraticCost.attr_defaults, **obst.OBSTACLE_ATTR_DEFAULTS}
    DEFAULTS = {**PointMassQuadraticCost.DEFAULTS, **obst.OBSTACLE_CONFIG_DEFAULTS}

    def _stage_cost_core_soa(self, xs, us, params):
        base = super()._stage_cost_core_soa(xs, us, params)
        return base + obst.obstacle_penalty(xs[0], xs[1], params)

    def terminal_cost_soa(self, xs, params):
        base = super().terminal_cost_soa(xs, params)
        return base + obst.obstacle_penalty(xs[0], xs[1], params)

    def cost_components(self, states, inputs, previous_input=None, params=None):
        params = params if params is not None else self.current_params()
        comps = super().cost_components(states, inputs, previous_input, params)
        comps["obstacles"] = obst.obstacle_penalty(states[..., 0], states[..., 1], params)
        return comps
