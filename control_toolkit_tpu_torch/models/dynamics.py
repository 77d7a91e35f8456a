"""Continuous-time dynamics (counterpart of control_toolkit_tpu/models/dynamics.py).

Each model is written once in struct-of-arrays (SOA) component form —
``f(xs: tuple[Tensor], us: tuple[Tensor], p) -> tuple[Tensor]`` — and the
``[..., S]`` array form is derived from it with ``soa_to_aos``.  The
arithmetic follows the JAX package's expressions term for term (and the
CUDA plant in ``csrc/plants.cuh`` follows the same order), so the scan
path, the plain kernel versions and the kernels round alike.

Ported are all eight plants of the JAX package: cartpole, pendulum,
acrobot, pointmass, quadrotor2d, quadrotor3d, car and arm2, each with its
``.fast`` variant (the polynomial trig of ``ops/fastmath.py``, which the
``:fast`` predictors select; pointmass has no trig, so its exact
dynamics double as the fast ones).
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


QUADROTOR2D_DEFAULTS = {
    "m": 0.5,        # vehicle mass [kg]
    "I": 0.01,       # pitch inertia [kg m^2]
    "arm": 0.17,     # rotor arm [m]
    "g": 9.81,
    "u_max": 7.5,    # max thrust PER rotor [N] (>> m*g/2 = 2.45: agile)
    "drag": 0.05,    # linear aero drag
}


def _quadrotor2d_derivs(xs, us, p, sincos):
    """Planar birotor: xs = (x, z, vx, vz, theta, omega), theta = 0 level;
    us = (t1_cmd, t2_cmd) in [0, 1] scaled to rotor thrusts; t2 > t1
    pitches up, and a positive theta tilts the thrust toward -x.  Hover:
    t = m*g / (2*u_max) on both rotors."""
    _, _, vx, vz, theta, omega = xs
    t1 = us[0] * p["u_max"]
    t2 = us[1] * p["u_max"]
    thrust = t1 + t2
    sin_t, cos_t = sincos(theta)
    inv_m = 1.0 / p["m"]
    ax = (-thrust * sin_t - p["drag"] * vx) * inv_m
    az = (thrust * cos_t - p["drag"] * vz) * inv_m - p["g"]
    alpha = (t2 - t1) * p["arm"] / p["I"]
    return (vx, vz, ax, az, omega, alpha)


def quadrotor2d_derivs_soa(xs, us, p):
    return _quadrotor2d_derivs(xs, us, p, lambda a: (torch.sin(a), torch.cos(a)))


def quadrotor2d_derivs_soa_fast(xs, us, p):
    """The planar quadrotor over ops/fastmath.py's polynomial sincos."""
    return _quadrotor2d_derivs(xs, us, p, fast_sincos)


QUADROTOR3D_DEFAULTS = {
    "m": 0.8,        # vehicle mass [kg]
    "Ix": 0.015,     # roll inertia [kg m^2]
    "Iy": 0.015,     # pitch inertia
    "Iz": 0.025,     # yaw inertia
    "arm": 0.17,     # rotor arm [m]
    "k_yaw": 0.016,  # rotor drag torque / thrust ratio [m]
    "g": 9.81,
    "u_max": 4.0,    # max thrust PER rotor [N] (> m*g/4 = 1.96)
    "drag": 0.1,     # linear aero drag
}


def _quadrotor3d_derivs(xs, us, p, sincos):
    """Full 3-D quadrotor, plus configuration, ZYX Euler attitude.

    xs = (x, y, z, vx, vy, vz, phi, theta, psi, wp, wq, wr): world position
    and velocity, roll/pitch/yaw, body rates; us = 4 rotor thrust commands
    in [0, 1] scaled by ``u_max``, rotors at +x (1), +y (2), -x (3), -y (4):
    roll torque arm*(t2 - t4), pitch torque arm*(t3 - t1), yaw torque
    k_yaw*(t1 - t2 + t3 - t4).  The Euler kinematics divide by cos(theta),
    clamped to |cos| >= 0.15 by branch-free selects (torch.maximum and
    torch.minimum split a tie's gradient in half, as jnp's do).
    """
    _, _, _, vx, vy, vz, phi, theta, psi, wp, wq, wr = xs
    t1 = us[0] * p["u_max"]
    t2 = us[1] * p["u_max"]
    t3 = us[2] * p["u_max"]
    t4 = us[3] * p["u_max"]
    thrust = t1 + t2 + t3 + t4

    s_ph, c_ph = sincos(phi)
    s_th, c_th = sincos(theta)
    s_ps, c_ps = sincos(psi)

    inv_m = 1.0 / p["m"]
    # World-frame thrust direction = R(phi, theta, psi) @ e3 (ZYX).
    ax = (thrust * (c_ph * s_th * c_ps + s_ph * s_ps) - p["drag"] * vx) * inv_m
    ay = (thrust * (c_ph * s_th * s_ps - s_ph * c_ps) - p["drag"] * vy) * inv_m
    az = (thrust * (c_ph * c_th) - p["drag"] * vz) * inv_m - p["g"]

    # Euler-rate kinematics with the clamped secant.
    c_th_safe = torch.where(
        c_th >= 0.0, torch.maximum(c_th, torch.full_like(c_th, 0.15)),
        torch.minimum(c_th, torch.full_like(c_th, -0.15)),
    )
    tan_th = s_th / c_th_safe
    phi_d = wp + (s_ph * wq + c_ph * wr) * tan_th
    theta_d = c_ph * wq - s_ph * wr
    psi_d = (s_ph * wq + c_ph * wr) / c_th_safe

    tau_x = p["arm"] * (t2 - t4)
    tau_y = p["arm"] * (t3 - t1)
    tau_z = p["k_yaw"] * (t1 - t2 + t3 - t4)
    wp_d = ((p["Iy"] - p["Iz"]) * wq * wr + tau_x) / p["Ix"]
    wq_d = ((p["Iz"] - p["Ix"]) * wp * wr + tau_y) / p["Iy"]
    wr_d = ((p["Ix"] - p["Iy"]) * wp * wq + tau_z) / p["Iz"]

    return (vx, vy, vz, ax, ay, az, phi_d, theta_d, psi_d, wp_d, wq_d, wr_d)


def quadrotor3d_derivs_soa(xs, us, p):
    return _quadrotor3d_derivs(xs, us, p, lambda a: (torch.sin(a), torch.cos(a)))


def quadrotor3d_derivs_soa_fast(xs, us, p):
    """The 3-D quadrotor over ops/fastmath.py's polynomial sincos."""
    return _quadrotor3d_derivs(xs, us, p, fast_sincos)


CAR_DEFAULTS = {
    "wheelbase": 0.3,    # [m] (f1tenth-class scale)
    "steer_max": 0.6,    # [rad] steering command scale
    "accel_max": 4.0,    # [m/s^2] acceleration command scale
    "drag": 0.4,         # velocity damping
    "v_max": 5.0,        # speed ceiling via drag saturation [m/s]
}


def _car_derivs(xs, us, p, sincos):
    """Kinematic bicycle: xs = (x, y, yaw, v); us = (steer_cmd, accel_cmd)
    in [-1, 1], scaled by ``steer_max``/``accel_max``; yawD = v *
    tan(steer) / wheelbase with tan = sin / cos (steer stays well inside
    (-pi/2, pi/2)); drag grows quadratically near ``v_max``."""
    _, _, yaw, v = xs
    steer = us[0] * p["steer_max"]
    accel = us[1] * p["accel_max"]
    s_y, c_y = sincos(yaw)
    s_d, c_d = sincos(steer)
    xd = v * c_y
    yd = v * s_y
    yawd = v * (s_d / c_d) / p["wheelbase"]
    vd = accel - p["drag"] * v * (1.0 + (v / p["v_max"]) ** 2)
    return (xd, yd, yawd, vd)


def car_derivs_soa(xs, us, p):
    return _car_derivs(xs, us, p, lambda a: (torch.sin(a), torch.cos(a)))


def car_derivs_soa_fast(xs, us, p):
    """The car over ops/fastmath.py's polynomial sincos (its steering's
    tangent too, so it differs from the exact dynamics)."""
    return _car_derivs(xs, us, p, fast_sincos)


ARM2_DEFAULTS = {
    "m1": 1.0, "m2": 1.0,      # link masses
    "l1": 0.5, "l2": 0.5,      # link lengths
    "lc1": 0.25, "lc2": 0.25,  # centers of mass
    "I1": 0.05, "I2": 0.05,    # link inertias about their CoM
    "g": 9.81,
    "b": 0.08,                 # viscous joint damping
    "u_max": 8.0,              # torque scale per joint [Nm]
}


def _arm2_derivs(xs, us, p, sincos):
    """Two-link planar manipulator, both joints torque-actuated, viscous
    damping: M(q) qdd + C(q, qd) qd + G(q) = tau, theta1 = 0 hanging down;
    three sincos (of theta2, theta1 and theta1 + theta2)."""
    t1, t1d, t2, t2d = xs
    tau1 = us[0] * p["u_max"]
    tau2 = us[1] * p["u_max"]
    m1, m2 = p["m1"], p["m2"]
    l1 = p["l1"]
    lc1, lc2 = p["lc1"], p["lc2"]
    I1, I2, g, b = p["I1"], p["I2"], p["g"], p["b"]

    s2, c2 = sincos(t2)
    s1, _ = sincos(t1)
    s12, _ = sincos(t1 + t2)

    h = m2 * l1 * lc2
    M11 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * c2) + I1 + I2
    M12 = m2 * (lc2**2 + l1 * lc2 * c2) + I2
    M22 = m2 * lc2**2 + I2
    g1 = (m1 * lc1 + m2 * l1) * g * s1 + m2 * lc2 * g * s12
    g2 = m2 * lc2 * g * s12
    r1 = tau1 + h * s2 * (t2d**2 + 2.0 * t1d * t2d) - g1 - b * t1d
    r2 = tau2 - h * s2 * t1d**2 - g2 - b * t2d
    det = M11 * M22 - M12 * M12
    t1dd = (M22 * r1 - M12 * r2) / det
    t2dd = (M11 * r2 - M12 * r1) / det
    return (t1d, t1dd, t2d, t2dd)


def arm2_derivs_soa(xs, us, p):
    return _arm2_derivs(xs, us, p, lambda a: (torch.sin(a), torch.cos(a)))


def arm2_derivs_soa_fast(xs, us, p):
    """The arm over ops/fastmath.py's polynomial sincos."""
    return _arm2_derivs(xs, us, p, fast_sincos)


def arm2_end_effector(t1, t2, l1, l2):
    """Fingertip position of the two-link arm (t1 = t2 = 0: (0, -(l1+l2))),
    the one expression that the environment's reward and the reaching cost
    share."""
    x = l1 * torch.sin(t1) + l2 * torch.sin(t1 + t2)
    y = -l1 * torch.cos(t1) - l2 * torch.cos(t1 + t2)
    return x, y


cartpole_dynamics = soa_to_aos(cartpole_derivs_soa, 4, 1)
cartpole_dynamics.fast = soa_to_aos(cartpole_derivs_soa_fast, 4, 1)
pendulum_dynamics = soa_to_aos(pendulum_derivs_soa, 2, 1)
pendulum_dynamics.fast = soa_to_aos(pendulum_derivs_soa_fast, 2, 1)
acrobot_dynamics = soa_to_aos(acrobot_derivs_soa, 4, 1)
acrobot_dynamics.fast = soa_to_aos(acrobot_derivs_soa_fast, 4, 1)
pointmass_dynamics = soa_to_aos(pointmass_derivs_soa, 4, 2)
pointmass_dynamics.fast = pointmass_dynamics
quadrotor2d_dynamics = soa_to_aos(quadrotor2d_derivs_soa, 6, 2)
quadrotor2d_dynamics.fast = soa_to_aos(quadrotor2d_derivs_soa_fast, 6, 2)
quadrotor3d_dynamics = soa_to_aos(quadrotor3d_derivs_soa, 12, 4)
quadrotor3d_dynamics.fast = soa_to_aos(quadrotor3d_derivs_soa_fast, 12, 4)
car_dynamics = soa_to_aos(car_derivs_soa, 4, 2)
car_dynamics.fast = soa_to_aos(car_derivs_soa_fast, 4, 2)
arm2_dynamics = soa_to_aos(arm2_derivs_soa, 4, 2)
arm2_dynamics.fast = soa_to_aos(arm2_derivs_soa_fast, 4, 2)

DYNAMICS = {
    "cartpole": (cartpole_dynamics, CARTPOLE_DEFAULTS, 4, 1),
    "pendulum": (pendulum_dynamics, PENDULUM_DEFAULTS, 2, 1),
    "acrobot": (acrobot_dynamics, ACROBOT_DEFAULTS, 4, 1),
    "pointmass": (pointmass_dynamics, POINTMASS_DEFAULTS, 4, 2),
    "quadrotor2d": (quadrotor2d_dynamics, QUADROTOR2D_DEFAULTS, 6, 2),
    "quadrotor3d": (quadrotor3d_dynamics, QUADROTOR3D_DEFAULTS, 12, 4),
    "car": (car_dynamics, CAR_DEFAULTS, 4, 2),
    "arm2": (arm2_dynamics, ARM2_DEFAULTS, 4, 2),
}

STATE_NAMES = {
    "cartpole": ["position", "positionD", "angle", "angleD"],
    "pendulum": ["angle", "angleD"],
    "acrobot": ["theta1", "theta1D", "theta2", "theta2D"],
    "pointmass": ["x", "y", "xD", "yD"],
    "quadrotor2d": ["x", "z", "xD", "zD", "theta", "thetaD"],
    "quadrotor3d": ["x", "y", "z", "xD", "yD", "zD",
                    "phi", "theta", "psi", "p", "q", "r"],
    "car": ["x", "y", "yaw", "v"],
    "arm2": ["theta1", "theta1D", "theta2", "theta2D"],
}
CONTROL_NAMES = {
    "cartpole": ["Q"],
    "pendulum": ["Q"],
    "acrobot": ["Q"],
    "pointmass": ["Fx", "Fy"],
    "quadrotor2d": ["T1", "T2"],
    "quadrotor3d": ["T1", "T2", "T3", "T4"],
    "car": ["steer", "accel"],
    "arm2": ["tau1", "tau2"],
}


def state_indices(environment_name: str) -> Dict:
    key = environment_name.lower()
    if key not in STATE_NAMES:
        raise KeyError(
            f"unknown environment {environment_name!r}; known: {sorted(STATE_NAMES)}"
        )
    return {n: i for i, n in enumerate(STATE_NAMES[key])}
