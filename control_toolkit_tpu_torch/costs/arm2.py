"""Two-link-manipulator cost (counterpart of control_toolkit_tpu/costs/arm2.py):
end-effector reaching.

State [theta1, theta1D, theta2, theta2D]; inputs [tau1, tau2].
``target_x``/``target_y`` (the fingertip's workspace target) are
attributes.  The cost is nonconvex through the forward kinematics
(elbow-up and elbow-down reach most targets).  Its link lengths ``l1``,
``l2`` mirror the dynamics' (``sync_with_dynamics``).  The CUDA plant
(``csrc/plants.cuh`` Arm2Cost) evaluates the same terms in the same
order.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.models.dynamics import arm2_end_effector
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("arm2/default")
@registry.cost_functions.register("arm2/reach")
class Arm2ReachCost(CostFunction):
    dynamic_config_keys = (
        "pos_weight", "vel_weight", "cc_weight", "ccrc_weight", "R",
        "l1", "l2",
    )
    attr_keys = ("target_x", "target_y")
    attr_defaults = {"target_x": 0.6, "target_y": 0.4}

    DEFAULTS = {
        "pos_weight": 30.0,
        "vel_weight": 0.15,
        "cc_weight": 0.05,
        "ccrc_weight": 0.05,
        "R": 1.0,
        # The forward kinematics' link lengths: seeded from the dynamics
        # unless set (mirrored_dynamics_keys).
        "l1": 0.5,
        "l2": 0.5,
    }

    mirrored_dynamics_keys = ("l1", "l2")

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _ee(self, t1, t2, w):
        return arm2_end_effector(t1, t2, w["l1"], w["l2"])

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.6)
        ty = attrs.get("target_y", 0.4)
        t1, t1d, t2, t2d = xs
        x, y = self._ee(t1, t2, w)
        pos = w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2)
        vel = w["vel_weight"] * (t1d**2 + t2d**2)
        cc = w["cc_weight"] * w["R"] * sum(u * u for u in us)
        return pos + vel + cc

    def terminal_cost_soa(self, xs, params):
        w = params["cost"]
        attrs = params["attrs"]
        tx = attrs.get("target_x", 0.6)
        ty = attrs.get("target_y", 0.4)
        t1, t1d, t2, t2d = xs
        x, y = self._ee(t1, t2, w)
        return 10.0 * w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2) + (
            w["vel_weight"] * (t1d**2 + t2d**2)
        )

    def cost_components(self, states, inputs, previous_input=None, params=None):
        """Named stage-cost terms ``[...]`` of states ``[..., 4]`` and
        inputs ``[..., 2]``."""
        params = params if params is not None else self.current_params()
        w = params["cost"]
        tx = params["attrs"].get("target_x", 0.6)
        ty = params["attrs"].get("target_y", 0.4)
        x, y = self._ee(states[..., 0], states[..., 2], w)
        return {
            "pos": w["pos_weight"] * ((x - tx) ** 2 + (y - ty) ** 2),
            "vel": w["vel_weight"] * (states[..., 1] ** 2 + states[..., 3] ** 2),
            "cc": w["cc_weight"] * w["R"] * torch.sum(inputs**2, dim=-1),
        }
