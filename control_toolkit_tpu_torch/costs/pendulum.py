"""Pendulum cost (counterpart of control_toolkit_tpu/costs/pendulum.py).

State: [angle, angleD]; angle 0 upright.  The CUDA plant
(``csrc/plants.cuh`` PendulumCost) evaluates the same terms in the same
order.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.utils import registry


@registry.cost_functions.register("pendulum/default")
@registry.cost_functions.register("pendulum/quadratic")
class PendulumQuadraticCost(CostFunction):
    """Swing-up cost with energy shaping: a wrap-invariant angle error, the
    energy error ``(E - E_upright)^2`` that rewards pumping from any phase,
    and a velocity penalty gated to near upright.  ``m``/``L``/``g`` mirror
    the pendulum dynamics' constants (``sync_with_dynamics``)."""

    dynamic_config_keys = (
        "angle_weight", "velocity_weight", "control_weight", "energy_weight",
        "m", "L", "g",
    )

    DEFAULTS = {
        "angle_weight": 50.0,
        "velocity_weight": 5.0,
        "control_weight": 0.01,
        "energy_weight": 0.05,
        "m": 1.0,
        "L": 1.0,
        "g": 9.81,
    }

    mirrored_dynamics_keys = ("m", "L", "g")

    def __init__(self, config=None):
        super().__init__(self._init_merged(config))

    def _stage_cost_core_soa(self, xs, us, params):
        w = params["cost"]
        angle, angle_d = xs
        # Total mechanical energy; upright at rest has E = m*g*L.
        m, L, g = w["m"], w["L"], w["g"]
        energy = 0.5 * m * L**2 * angle_d**2 + m * g * L * torch.cos(angle)
        energy_err = (energy - m * g * L) ** 2
        near_top = 0.5 * (1.0 + torch.cos(angle))
        return (
            w["angle_weight"] * (1.0 - torch.cos(angle))
            + w["energy_weight"] * energy_err
            + w["velocity_weight"] * near_top * angle_d**2
            + w["control_weight"] * sum(u * u for u in us)
        )
