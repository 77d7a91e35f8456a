"""Cartpole cost (counterpart of control_toolkit_tpu/costs/cartpole.py).

State: [position, positionD, angle, angleD]; angle 0 == pole upright.
The CUDA plant (``csrc/plants.cuh``) evaluates the same terms in the
same order.
"""
from __future__ import annotations

import math

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("cartpole/default")
@registry.cost_functions.register("cartpole/quadratic")
class CartpoleQuadraticCost(CostFunction):
    """Swing-up/stabilization cost with target-position tracking
    (dd=distance, ep=pole potential, ekp=pole kinetic, cc=control cost,
    ccrc=control-change cost); ``target_position`` is an attribute."""

    dynamic_config_keys = (
        "dd_weight", "ep_weight", "ekp_weight", "cc_weight", "ccrc_weight", "R",
    )
    attr_keys = ("target_position",)
    attr_defaults = {"target_position": 0.0}

    DEFAULTS = {
        "dd_weight": 120.0,
        "ep_weight": 10000.0,
        "ekp_weight": 10.0,
        "cc_weight": 1.0,
        "ccrc_weight": 1.0,
        "R": 1.0,
    }

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        target = params["attrs"].get("target_position", 0.0)

        pos, _, angle, angle_d = xs

        dd = w["dd_weight"] * (pos - target) ** 2
        ep = w["ep_weight"] * 0.25 * (1.0 - torch.cos(angle)) ** 2
        ekp = w["ekp_weight"] * (angle_d / (2.0 * math.pi)) ** 2
        cc = w["cc_weight"] * w["R"] * sum(u * u for u in us)
        return dd + ep + ekp + cc

    def terminal_cost_soa(self, xs, params):
        # Penalize terminal pole-down configurations.
        _, _, angle, angle_d = xs
        return 1.0e4 * (1.0 - torch.cos(angle)) ** 2 + 10.0 * angle_d**2
