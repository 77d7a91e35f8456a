"""Planar-quadrotor cost (counterpart of control_toolkit_tpu/costs/quadrotor2d.py):
waypoint tracking with attitude and rate damping.

State [x, z, xD, zD, theta, thetaD]; two thrust inputs in [0, 1].
``target_x``/``target_z`` are attributes (``params["attrs"]``, target_z
defaulting to the hover height 1.0 on both the dict and the packed
kernel path).  The control cost is measured from the HOVER thrust, not
from zero: a rotor cannot push down.  The CUDA plant
(``csrc/plants.cuh`` Quadrotor2DCost) evaluates the same terms in the
same order.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("quadrotor2d/default")
@registry.cost_functions.register("quadrotor2d/waypoint")
class Quadrotor2DWaypointCost(CostFunction):
    dynamic_config_keys = (
        "pos_weight", "vel_weight", "tilt_weight", "rate_weight",
        "cc_weight", "ccrc_weight", "hover_thrust",
    )
    attr_keys = ("target_x", "target_z")
    attr_defaults = {"target_x": 0.0, "target_z": 1.0}

    DEFAULTS = {
        "pos_weight": 40.0,
        "vel_weight": 2.0,
        "tilt_weight": 5.0,
        "rate_weight": 0.5,
        "cc_weight": 2.0,
        "ccrc_weight": 1.0,
        "hover_thrust": 0.327,  # m*g/(2*u_max) for the built-in dynamics constants
    }

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.0)
        tz = attrs.get("target_z", 1.0)
        x, z, vx, vz, theta, omega = xs
        pos = w["pos_weight"] * ((x - tx) ** 2 + (z - tz) ** 2)
        vel = w["vel_weight"] * (vx**2 + vz**2)
        tilt = w["tilt_weight"] * (1.0 - torch.cos(theta))
        rate = w["rate_weight"] * omega**2
        cc = w["cc_weight"] * sum((u - w["hover_thrust"]) ** 2 for u in us)
        return pos + vel + tilt + rate + cc

    def terminal_cost_soa(self, xs, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.0)
        tz = attrs.get("target_z", 1.0)
        x, z, vx, vz, theta, omega = xs
        return (
            10.0 * w["pos_weight"] * ((x - tx) ** 2 + (z - tz) ** 2)
            + w["vel_weight"] * (vx**2 + vz**2)
            + 10.0 * w["tilt_weight"] * (1.0 - torch.cos(theta))
        )

    def cost_components(self, states, inputs, previous_input=None, params=None):
        """Named stage-cost terms ``[...]`` of states ``[..., 6]`` and
        inputs ``[..., 2]``."""
        params = params if params is not None else self.current_params()
        w = params["cost"]
        tx = params["attrs"].get("target_x", 0.0)
        tz = params["attrs"].get("target_z", 1.0)
        return {
            "pos": w["pos_weight"] * ((states[..., 0] - tx) ** 2 + (states[..., 1] - tz) ** 2),
            "vel": w["vel_weight"] * (states[..., 2] ** 2 + states[..., 3] ** 2),
            "tilt": w["tilt_weight"] * (1.0 - torch.cos(states[..., 4])),
            "rate": w["rate_weight"] * states[..., 5] ** 2,
            "cc": w["cc_weight"] * torch.sum((inputs - w["hover_thrust"]) ** 2, dim=-1),
        }
