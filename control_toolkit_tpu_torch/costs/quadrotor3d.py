"""3-D quadrotor cost (counterpart of control_toolkit_tpu/costs/quadrotor3d.py):
waypoint tracking with attitude and rate damping.

State [x, y, z, vx, vy, vz, phi, theta, psi, p, q, r]; four thrust inputs
in [0, 1].  ``target_x``/``target_y``/``target_z`` and ``target_yaw`` are
attributes.  The control cost is measured from the HOVER thrust (one-sided
rotors).  The CUDA plant (``csrc/plants.cuh`` Quadrotor3DCost) evaluates
the same terms in the same order.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("quadrotor3d/default")
@registry.cost_functions.register("quadrotor3d/waypoint")
class Quadrotor3DWaypointCost(CostFunction):
    dynamic_config_keys = (
        "pos_weight", "vel_weight", "tilt_weight", "yaw_weight",
        "rate_weight", "cc_weight", "ccrc_weight", "hover_thrust",
    )
    attr_keys = ("target_x", "target_y", "target_z", "target_yaw")
    attr_defaults = {
        "target_x": 0.0, "target_y": 0.0, "target_z": 1.0, "target_yaw": 0.0,
    }

    DEFAULTS = {
        "pos_weight": 40.0,
        "vel_weight": 2.0,
        "tilt_weight": 5.0,
        "yaw_weight": 1.0,
        "rate_weight": 0.5,
        "cc_weight": 2.0,
        "ccrc_weight": 1.0,
        "hover_thrust": 0.4905,  # m*g/(4*u_max) for the built-in dynamics constants
    }

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    @staticmethod
    def _targets(attrs):
        return (
            attrs.get("target_x", 0.0),
            attrs.get("target_y", 0.0),
            attrs.get("target_z", 1.0),
            attrs.get("target_yaw", 0.0),
        )

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        tx, ty, tz, tpsi = self._targets(params["attrs"])
        x, y, z, vx, vy, vz, phi, theta, psi, wp, wq, wr = xs
        pos = w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2 + (z - tz) ** 2)
        vel = w["vel_weight"] * (vx**2 + vy**2 + vz**2)
        tilt = w["tilt_weight"] * (2.0 - torch.cos(phi) - torch.cos(theta))
        yaw = w["yaw_weight"] * (1.0 - torch.cos(psi - tpsi))
        rate = w["rate_weight"] * (wp**2 + wq**2 + wr**2)
        cc = w["cc_weight"] * sum((u - w["hover_thrust"]) ** 2 for u in us)
        return pos + vel + tilt + yaw + rate + cc

    def terminal_cost_soa(self, xs, params):
        w = params["cost"]
        tx, ty, tz, _ = self._targets(params["attrs"])
        x, y, z, vx, vy, vz, phi, theta, _, _, _, _ = xs
        return (
            10.0 * w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2 + (z - tz) ** 2)
            + w["vel_weight"] * (vx**2 + vy**2 + vz**2)
            + 10.0 * w["tilt_weight"] * (2.0 - torch.cos(phi) - torch.cos(theta))
        )

    def cost_components(self, states, inputs, previous_input=None, params=None):
        """Named stage-cost terms ``[...]`` of states ``[..., 12]`` and
        inputs ``[..., 4]``."""
        params = params if params is not None else self.current_params()
        w = params["cost"]
        tx, ty, tz, tpsi = self._targets(params["attrs"])
        return {
            "pos": w["pos_weight"] * ((states[..., 0] - tx) ** 2 + (states[..., 1] - ty) ** 2
                                      + (states[..., 2] - tz) ** 2),
            "vel": w["vel_weight"] * torch.sum(states[..., 3:6] ** 2, dim=-1),
            "tilt": w["tilt_weight"] * (2.0 - torch.cos(states[..., 6])
                                        - torch.cos(states[..., 7])),
            "yaw": w["yaw_weight"] * (1.0 - torch.cos(states[..., 8] - tpsi)),
            "rate": w["rate_weight"] * torch.sum(states[..., 9:12] ** 2, dim=-1),
            "cc": w["cc_weight"] * torch.sum((inputs - w["hover_thrust"]) ** 2, dim=-1),
        }
