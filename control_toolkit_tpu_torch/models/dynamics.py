"""Continuous-time dynamics (counterpart of control_toolkit_tpu/models/dynamics.py).

Each model is written once in struct-of-arrays (SOA) component form —
``f(xs: tuple[Tensor], us: tuple[Tensor], p) -> tuple[Tensor]`` — and the
``[..., S]`` array form is derived from it with ``soa_to_aos``.  The
arithmetic follows the JAX package's expressions term for term (and the
CUDA plant in ``csrc/plants.cuh`` follows the same order), so the scan
path, the plain kernel versions and the kernels round alike.

Only cartpole is ported so far, with its ``.fast`` variant
(``cartpole_dynamics.fast``: the polynomial trig of ``ops/fastmath.py``,
which the ``:fast`` predictors select); the other plants and their
``.fast`` variants are still to be ported (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from control_toolkit_tpu_torch.ops.fastmath import fast_sincos

DynamicsFn = Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]

CARTPOLE_DEFAULTS = {
    "m_cart": 1.0,       # cart mass [kg]
    "m_pole": 0.1,       # pole mass [kg]
    "L": 0.5,            # half pole length [m]
    "g": 9.81,
    "u_max": 10.0,       # force scale: u in [-1,1] -> force [N]
    "friction_cart": 0.0,
    "friction_pole": 0.0,
}


def _cartpole_derivs(xs: Tuple, us: Tuple, p: Dict, sincos) -> Tuple:
    """Cart-pole ODE in component form (pole balancing upward at angle=0).
    xs = (position, positionD, angle, angleD); us = (force_cmd,)."""
    _, pos_d, theta, theta_d = xs
    force = us[0] * p["u_max"]

    m_c, m_p, L, g = p["m_cart"], p["m_pole"], p["L"], p["g"]
    sin_t, cos_t = sincos(theta)
    total_m = m_c + m_p

    temp = (force + m_p * L * theta_d**2 * sin_t - p["friction_cart"] * pos_d) / total_m
    theta_dd = (g * sin_t - cos_t * temp - p["friction_pole"] * theta_d / (m_p * L)) / (
        L * (4.0 / 3.0 - m_p * cos_t**2 / total_m)
    )
    pos_dd = temp - m_p * L * theta_dd * cos_t / total_m
    return (pos_d, pos_dd, theta_d, theta_dd)


def cartpole_derivs_soa(xs: Tuple, us: Tuple, p: Dict) -> Tuple:
    return _cartpole_derivs(xs, us, p, lambda a: (torch.sin(a), torch.cos(a)))


def cartpole_derivs_soa_fast(xs: Tuple, us: Tuple, p: Dict) -> Tuple:
    """The cart-pole ODE over ops/fastmath.py's polynomial sin and cos."""
    return _cartpole_derivs(xs, us, p, fast_sincos)


def soa_to_aos(derivs_soa: Callable, num_states: int, num_controls: int) -> DynamicsFn:
    """Lift a component-form derivative to the [..., S] array form."""

    def f(x: torch.Tensor, u: torch.Tensor, p: Dict) -> torch.Tensor:
        xs = tuple(x[..., i] for i in range(num_states))
        us = tuple(u[..., j] for j in range(num_controls))
        return torch.stack(derivs_soa(xs, us, p), dim=-1)

    f.soa = derivs_soa
    f.num_states = num_states
    f.num_controls = num_controls
    return f


cartpole_dynamics = soa_to_aos(cartpole_derivs_soa, 4, 1)
cartpole_dynamics.fast = soa_to_aos(cartpole_derivs_soa_fast, 4, 1)

DYNAMICS = {
    "cartpole": (cartpole_dynamics, CARTPOLE_DEFAULTS, 4, 1),
}

STATE_NAMES = {
    "cartpole": ["position", "positionD", "angle", "angleD"],
}


def state_indices(environment_name: str) -> Dict:
    key = environment_name.lower()
    if key not in STATE_NAMES:
        raise KeyError(
            f"unknown environment {environment_name!r}; known: {sorted(STATE_NAMES)}"
        )
    return {n: i for i, n in enumerate(STATE_NAMES[key])}
