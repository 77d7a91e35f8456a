"""Car (kinematic bicycle) costs (counterpart of control_toolkit_tpu/costs/car.py):
waypoint reaching for a nonholonomic vehicle, and the same through
circular obstacles.

State [x, y, yaw, v]; inputs [steer_cmd, accel_cmd].  ``target_x``/
``target_y`` are attributes.  Speed is penalized near the target alone
(arrive slow, travel fast): the vel term weights v^2 by a smooth bump
around the target.  The CUDA plants (``csrc/plants.cuh`` CarCost,
CarObstacleCost) evaluate the same terms in the same order.
"""
from __future__ import annotations

from control_toolkit_tpu_torch.costs import obstacles as obst
from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("car/default")
@registry.cost_functions.register("car/waypoint")
class CarWaypointCost(CostFunction):
    dynamic_config_keys = (
        "pos_weight", "vel_weight", "arrive_radius", "steer_weight",
        "cc_weight", "ccrc_weight",
    )
    attr_keys = ("target_x", "target_y")
    attr_defaults = {"target_x": 0.0, "target_y": 0.0}

    DEFAULTS = {
        "pos_weight": 10.0,
        "vel_weight": 2.0,
        "arrive_radius": 0.5,
        "steer_weight": 0.1,
        "cc_weight": 0.1,
        "ccrc_weight": 0.1,
    }

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _terms(self, x, y, yaw, v, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.0)
        ty = attrs.get("target_y", 0.0)
        d2 = (x - tx) ** 2 + (y - ty) ** 2
        pos = w["pos_weight"] * d2
        # near = 1 at the waypoint, -> 0 beyond arrive_radius.
        r2 = w["arrive_radius"] ** 2
        near = r2 / (r2 + d2)
        vel = w["vel_weight"] * near * v**2
        return pos + vel

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        x, y, yaw, v = xs
        cc = (w["steer_weight"] * us[0] ** 2
              + w["cc_weight"] * us[1] ** 2)
        return self._terms(x, y, yaw, v, params) + cc

    def terminal_cost_soa(self, xs, params):
        x, y, yaw, v = xs
        return 10.0 * self._terms(x, y, yaw, v, params)

    def cost_components(self, states, inputs, previous_input=None, params=None):
        """Named stage-cost terms ``[...]`` of states ``[..., 4]`` and
        inputs ``[..., 2]``."""
        params = params if params is not None else self.current_params()
        w = params["cost"]
        return {
            "tracking": self._terms(states[..., 0], states[..., 1],
                                    states[..., 2], states[..., 3], params),
            "steer": w["steer_weight"] * inputs[..., 0] ** 2,
            "accel": w["cc_weight"] * inputs[..., 1] ** 2,
        }


@registry.cost_functions.register("car/obstacles")
class CarObstacleCost(CarWaypointCost):
    """Waypoint driving through circular obstacles: the car must plan
    around discs it cannot sidestep (``costs/obstacles.py``: the penalty
    and its attribute layout, shared with pointmass/obstacles)."""

    dynamic_config_keys = CarWaypointCost.dynamic_config_keys + obst.OBSTACLE_CONFIG_KEYS
    attr_keys = CarWaypointCost.attr_keys + obst.OBSTACLE_ATTR_KEYS
    attr_defaults = {**CarWaypointCost.attr_defaults, **obst.OBSTACLE_ATTR_DEFAULTS}
    DEFAULTS = {**CarWaypointCost.DEFAULTS, **obst.OBSTACLE_CONFIG_DEFAULTS}

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
