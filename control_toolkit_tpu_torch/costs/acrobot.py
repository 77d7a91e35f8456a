"""Acrobot swing-up cost (counterpart of control_toolkit_tpu/costs/acrobot.py):
tip-height shaping and damping near the top.  The CUDA plant
(``csrc/plants.cuh`` AcrobotCost) evaluates the same terms in the same
order."""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("acrobot/default")
class AcrobotSwingupCost(CostFunction):
    """Stage cost on the tip height ``-l1 cos(t1) - l2 cos(t1 + t2)``
    (at most l1 + l2, both links up), the velocity penalty gated to near
    the top; ``l1``/``l2`` mirror the acrobot dynamics' link lengths."""

    dynamic_config_keys = (
        "height_weight", "velocity_weight", "control_weight", "l1", "l2",
    )

    DEFAULTS = {
        "height_weight": 10.0,
        "velocity_weight": 0.3,
        "control_weight": 0.01,
        "l1": 1.0,
        "l2": 1.0,
    }

    mirrored_dynamics_keys = ("l1", "l2")

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        t1, t1d, t2, t2d = xs
        l1, l2 = w["l1"], w["l2"]
        height = -l1 * torch.cos(t1) - l2 * torch.cos(t1 + t2)
        max_h = l1 + l2
        hm = height / max_h
        near_top = torch.maximum(hm, torch.zeros_like(hm)) ** 2
        return (
            w["height_weight"] * (max_h - height)
            + w["velocity_weight"] * near_top * (t1d**2 + t2d**2)
            + w["control_weight"] * sum(u * u for u in us)
        )
