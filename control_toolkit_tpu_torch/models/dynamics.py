"""Continuous-time dynamics (counterpart of control_toolkit_tpu/models/dynamics.py).

Each model is written once in struct-of-arrays (SOA) component form —
``f(xs: tuple[Tensor], us: tuple[Tensor], p) -> tuple[Tensor]`` — and the
``[..., S]`` array form is derived from it with ``soa_to_aos``.  The
arithmetic follows the JAX package's expressions term for term (and the
CUDA plant in ``csrc/plants.cuh`` follows the same order), so the scan
path, the plain kernel versions and the kernels round alike.

Ported are cartpole, pendulum, acrobot and pointmass, each with its
``.fast`` variant (the polynomial trig of ``ops/fastmath.py``, which the
``:fast`` predictors select; pointmass has no trig, so its exact
dynamics double as the fast ones); quadrotor2d, quadrotor3d, car and arm2
are still to be ported (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from control_toolkit_tpu_torch.ops.fastmath import fast_sin, fast_sincos

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

PENDULUM_DEFAULTS = {
    "m": 1.0,
    "L": 1.0,
    "g": 9.81,
    "u_max": 6.0,   # underactuated (< m*g*L) but swing-up feasible in ~2 s
    "damping": 0.0,
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


def _pendulum_derivs(xs: Tuple, us: Tuple, p: Dict, sin) -> Tuple:
    """Inverted pendulum ODE; angle = 0 is upright, torque-actuated."""
    theta, theta_d = xs
    torque = us[0] * p["u_max"]
    theta_dd = (
        p["g"] / p["L"] * sin(theta)
        + torque / (p["m"] * p["L"] ** 2)
        - p["damping"] * theta_d
    )
    return (theta_d, theta_dd)


def pendulum_derivs_soa(xs: Tuple, us: Tuple, p: Dict) -> Tuple:
    return _pendulum_derivs(xs, us, p, torch.sin)


def pendulum_derivs_soa_fast(xs: Tuple, us: Tuple, p: Dict) -> Tuple:
    """The pendulum ODE over ops/fastmath.py's polynomial sin."""
    return _pendulum_derivs(xs, us, p, fast_sin)


ACROBOT_DEFAULTS = {
    "m1": 1.0, "m2": 1.0,      # link masses
    "l1": 1.0, "l2": 1.0,      # link lengths
    "lc1": 0.5, "lc2": 0.5,    # centers of mass
    "I1": 1.0, "I2": 1.0,      # link inertias
    "g": 9.8,
    "u_max": 10.0,             # elbow torque scale
}


def _acrobot_derivs(xs, us, p, sin, sincos):
    """Acrobot (two-link pendulum actuated at the elbow), Spong dynamics.
    xs = (theta1, theta1D, theta2, theta2D); theta1 = 0 is hanging down;
    one sincos (of theta2) and two sins (of theta1 + theta2 and theta1)."""
    t1, t1d, t2, t2d = xs
    tau = us[0] * p["u_max"]
    m1, m2 = p["m1"], p["m2"]
    l1 = p["l1"]
    lc1, lc2 = p["lc1"], p["lc2"]
    I1, I2, g = p["I1"], p["I2"], p["g"]

    s2, c2 = sincos(t2)
    d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * c2) + I1 + I2
    d2 = m2 * (lc2**2 + l1 * lc2 * c2) + I2
    phi2 = m2 * lc2 * g * sin(t1 + t2)
    phi1 = (
        -m2 * l1 * lc2 * t2d**2 * s2
        - 2 * m2 * l1 * lc2 * t2d * t1d * s2
        + (m1 * lc1 + m2 * l1) * g * sin(t1)
        + phi2
    )
    t2dd = (
        tau + (d2 / d1) * phi1 - m2 * l1 * lc2 * t1d**2 * s2 - phi2
    ) / (m2 * lc2**2 + I2 - d2**2 / d1)
    t1dd = -(d2 * t2dd + phi1) / d1
    return (t1d, t1dd, t2d, t2dd)


def acrobot_derivs_soa(xs, us, p):
    return _acrobot_derivs(xs, us, p, torch.sin, lambda a: (torch.sin(a), torch.cos(a)))


def acrobot_derivs_soa_fast(xs, us, p):
    """The acrobot ODE over ops/fastmath.py's polynomial sin and sincos."""
    return _acrobot_derivs(xs, us, p, fast_sin, fast_sincos)


POINTMASS_DEFAULTS = {
    "mass": 1.0,
    "drag": 0.2,     # linear velocity damping
    "u_max": 5.0,    # force scale per input
}


def pointmass_derivs_soa(xs, us, p):
    """Planar point mass, the multi-input plant: xs = (x, y, vx, vy); us =
    (fx_cmd, fy_cmd) in [-1, 1] scaled by u_max.  No transcendentals, so
    the exact derivs double as the fast variant."""
    _, _, vx, vy = xs
    inv_m = 1.0 / p["mass"]
    ax = (us[0] * p["u_max"] - p["drag"] * vx) * inv_m
    ay = (us[1] * p["u_max"] - p["drag"] * vy) * inv_m
    return (vx, vy, ax, ay)


cartpole_dynamics = soa_to_aos(cartpole_derivs_soa, 4, 1)
cartpole_dynamics.fast = soa_to_aos(cartpole_derivs_soa_fast, 4, 1)
pendulum_dynamics = soa_to_aos(pendulum_derivs_soa, 2, 1)
pendulum_dynamics.fast = soa_to_aos(pendulum_derivs_soa_fast, 2, 1)
acrobot_dynamics = soa_to_aos(acrobot_derivs_soa, 4, 1)
acrobot_dynamics.fast = soa_to_aos(acrobot_derivs_soa_fast, 4, 1)
pointmass_dynamics = soa_to_aos(pointmass_derivs_soa, 4, 2)
pointmass_dynamics.fast = pointmass_dynamics

DYNAMICS = {
    "cartpole": (cartpole_dynamics, CARTPOLE_DEFAULTS, 4, 1),
    "pendulum": (pendulum_dynamics, PENDULUM_DEFAULTS, 2, 1),
    "acrobot": (acrobot_dynamics, ACROBOT_DEFAULTS, 4, 1),
    "pointmass": (pointmass_dynamics, POINTMASS_DEFAULTS, 4, 2),
}

STATE_NAMES = {
    "cartpole": ["position", "positionD", "angle", "angleD"],
    "pendulum": ["angle", "angleD"],
    "acrobot": ["theta1", "theta1D", "theta2", "theta2D"],
    "pointmass": ["x", "y", "xD", "yD"],
}
CONTROL_NAMES = {
    "cartpole": ["Q"],
    "pendulum": ["Q"],
    "acrobot": ["Q"],
    "pointmass": ["Fx", "Fy"],
}


def state_indices(environment_name: str) -> Dict:
    key = environment_name.lower()
    if key not in STATE_NAMES:
        raise KeyError(
            f"unknown environment {environment_name!r}; known: {sorted(STATE_NAMES)}"
        )
    return {n: i for i, n in enumerate(STATE_NAMES[key])}
