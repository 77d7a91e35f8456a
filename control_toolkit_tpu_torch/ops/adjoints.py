"""Hand-written adjoints of the rollout: the transposed Jacobians that the
JAX gradient kernel gets from ``jax.vjp`` at trace time
(control_toolkit_tpu/ops/pallas_grad.py:203 and :225-230).

All functions work in component form (tuples of ``[K]`` tensors) on the
packed-parameter dict ``p`` that ``RolloutModel.unpack`` gives (keys
``d_*``, ``c_*``, ``a_*``, ``__u_prev_j``), the form the CUDA plant reads.
``csrc/plants.cuh`` and ``csrc/rollout_core.cuh`` transcribe them term
for term, so these are the formulas the tests hold against
``torch.autograd``; ``cartpole_derivs_jac`` and ``integrator_jac`` give
the per-step Jacobians, in forward mode, of K7's time-parallel adjoint.
The cartpole plant's are written over its trig's values and derivatives
(``exact_sincos_d``); the fast plant's (``cartpole_fast_derivs_*``) take
ops/fastmath.py's polynomials and their derivatives.  The pendulum,
acrobot, pointmass, quadrotor2d, quadrotor3d, car and arm2 plants' are
written as their Jacobian's nontrivial rows (``*_derivs_jac``; the other
rows are the unit rows of the velocities), from which their VJPs contract
(``_vjp_from_jac``); their costs' gradients (``*_stage_vjp``,
``*_terminal_grad``) and the quadrotor3d's clamped secant
(``secant_clamp_d``) take a ``maximum``'s or ``minimum``'s tie as
``jax.vjp`` does, half the cotangent to each side (``_tie``).
``mlp_step_vjp`` is the learned MLP step's adjoint over the net's weight
dict, transcribed into ``csrc/mlp_mma.cuh``;
``residual_step_vjp`` (the ``"ODE+res"`` step) combines it with the
integrator's, and ``gp_step_vjp`` is the sparse-GP step's, transcribed
into ``csrc/gp_core.cuh``.
Only gradients with respect to states and controls are formed;
parameters and weights get none.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from control_toolkit_tpu_torch.ops.fastmath import fast_sincos_d
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper, tadd, tscale


def exact_sincos_d(theta):
    """``(sin, cos, dsin, ndcos)``: the values and the derivative of sin
    and the derivative of cos, negated — for exact trig ``cos`` and ``sin``
    again (ops/fastmath.py:fast_sincos_d is the fast plant's)."""
    sin_t, cos_t = theta.sin(), theta.cos()
    return sin_t, cos_t, cos_t, sin_t


def cartpole_derivs_vjp(xs: Tuple, us: Tuple, p, lam: Tuple,
                        sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, Tuple]:
    """``lam^T d f / d(x, u)`` for models/dynamics.py:_cartpole_derivs over
    the trig of ``sincos_d`` (its values and derivatives)."""
    _, pos_d, theta, theta_d = xs
    l0, l1, l2, l3 = lam
    m_p, L = p["d_m_pole"], p["d_L"]
    fc, fp = p["d_friction_cart"], p["d_friction_pole"]
    force = us[0] * p["d_u_max"]
    sin_t, cos_t, dsin, ndcos = sincos_d(theta)
    total_m = p["d_m_cart"] + m_p
    mpl = m_p * L
    # The forward values the transposed terms need.
    temp = (force + mpl * (theta_d * theta_d) * sin_t - fc * pos_d) / total_m
    num = p["d_g"] * sin_t - cos_t * temp - fp * theta_d / mpl
    den = L * (4.0 / 3.0 - m_p * (cos_t * cos_t) / total_m)
    theta_dd = num / den
    # pos_dd = temp - mpl * theta_dd * cos_t / total_m
    g_temp = l1
    g_thdd = l3 - l1 * mpl * cos_t / total_m
    g_cos = -(l1 * mpl * theta_dd / total_m)
    # theta_dd = num / den
    g_num = g_thdd / den
    g_den = -(g_thdd * theta_dd / den)
    # den = L * (4/3 - m_p * cos^2 / total_m)
    g_cos = g_cos - g_den * L * m_p * 2.0 * cos_t / total_m
    # num = g * sin - cos * temp - fp * theta_d / mpl
    g_sin = g_num * p["d_g"]
    g_cos = g_cos - g_num * temp
    g_temp = g_temp - g_num * cos_t
    g_thd = l2 - g_num * fp / mpl
    # temp = (force + mpl * theta_d^2 * sin - fc * pos_d) / total_m
    g_a = g_temp / total_m
    g_thd = g_thd + g_a * mpl * 2.0 * theta_d * sin_t
    g_sin = g_sin + g_a * mpl * (theta_d * theta_d)
    g_posd = l0 - g_a * fc
    g_theta = g_sin * dsin - g_cos * ndcos
    return (torch.zeros_like(pos_d), g_posd, g_theta, g_thd), (g_a * p["d_u_max"],)


def cartpole_derivs_jac(xs: Tuple, us: Tuple, p,
                        sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_cartpole_derivs at (x, u): f, and
    ``J = d f / d(x, u)`` ``[K, S, S+U]``, the state's columns first, then
    the control's, over the trig of ``sincos_d``.  Three reciprocals take
    the place of the derivs' divisions, as in ``csrc/plants.cuh``
    derivs_tangent, which multiplies J's two nontrivial rows (1 and 3) into
    a tangent."""
    _, pos_d, theta, theta_d = xs
    m_p, L, g = p["d_m_pole"], p["d_L"], p["d_g"]
    fc, fp = p["d_friction_cart"], p["d_friction_pole"]
    force = us[0] * p["d_u_max"]
    sin_t, cos_t, dsin, ndcos = sincos_d(theta)
    mpl = m_p * L
    inv_m, inv_mpl = 1.0 / (p["d_m_cart"] + m_p), 1.0 / mpl
    temp = (force + mpl * (theta_d * theta_d) * sin_t - fc * pos_d) * inv_m
    num = g * sin_t - cos_t * temp - fp * theta_d * inv_mpl
    inv_den = 1.0 / (L * (4.0 / 3.0 - m_p * (cos_t * cos_t) * inv_m))
    theta_dd = num * inv_den
    f = (pos_d, temp - mpl * theta_dd * cos_t * inv_m, theta_d, theta_dd)
    # temp's partials in pos_d, theta, theta_d and u
    zero = torch.zeros_like(pos_d)
    t1 = zero + (-fc * inv_m)
    t2 = mpl * (theta_d * theta_d) * dsin * inv_m
    t3 = mpl * 2.0 * theta_d * sin_t * inv_m
    tu = zero + p["d_u_max"] * inv_m
    # num's, and den's in theta
    n1 = -(cos_t * t1)
    n2 = g * dsin + ndcos * temp - cos_t * t2
    n3 = -(cos_t * t3) - fp * inv_mpl
    nu = -(cos_t * tu)
    d2 = L * (m_p * 2.0 * cos_t * ndcos * inv_m)
    # theta_dd = num / den
    a1, a2, a3, au = n1 * inv_den, (n2 - theta_dd * d2) * inv_den, n3 * inv_den, nu * inv_den
    # pos_dd = temp - mpl * theta_dd * cos_t / total_m
    c = mpl * inv_m
    b1 = t1 - c * (a1 * cos_t)
    b2 = t2 - c * (a2 * cos_t - theta_dd * ndcos)
    b3 = t3 - c * (a3 * cos_t)
    bu = tu - c * (au * cos_t)
    one = torch.ones_like(pos_d)
    rows = ((zero, one, zero, zero, zero), (zero, b1, b2, b3, bu),
            (zero, zero, zero, one, zero), (zero, a1, a2, a3, au))
    return f, torch.stack([torch.stack(row, dim=1) for row in rows], dim=1)


def cartpole_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct) -> Tuple[Tuple, Tuple, Tuple]:
    """Gradient of ``ct *`` Optimizer._soa_bindings' stage_soa for the
    cartpole/default cost (costs/cartpole.py:_stage_cost_core_soa plus
    ``ccrc_weight * (u - prev)^2``; ``-MAX_COST`` has none).  Returns
    ``(gx, gu, gprev)`` with ``gprev = -2 * ccrc * (u - prev) * ct``."""
    pos, pos_d, angle, angle_d = xs
    two_pi = 2.0 * math.pi
    g_pos = ct * (2.0 * p["c_dd_weight"]) * (pos - p["a_target_position"])
    g_angle = ct * (0.5 * p["c_ep_weight"]) * (1.0 - angle.cos()) * angle.sin()
    g_angle_d = ct * (2.0 * p["c_ekp_weight"]) * (angle_d / two_pi) / two_pi
    cc = 2.0 * p["c_cc_weight"] * p["c_R"]
    ccrc = 2.0 * p["c_ccrc_weight"]
    gu, gprev = [], []
    for u, pu in zip(us, prev_us):
        dchange = ct * ccrc * (u - pu)
        gu.append(ct * cc * u + dchange)
        gprev.append(-dchange)
    return (g_pos, torch.zeros_like(pos_d), g_angle, g_angle_d), tuple(gu), tuple(gprev)


def cartpole_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    """Gradient of ``ct *`` costs/cartpole.py:terminal_cost_soa
    (``1e4 * (1 - cos)^2 + 10 * angle_d^2``)."""
    pos, pos_d, angle, angle_d = xs
    g_angle = ct * 2.0e4 * (1.0 - angle.cos()) * angle.sin()
    g_angle_d = ct * 20.0 * angle_d
    return (torch.zeros_like(pos), torch.zeros_like(pos_d), g_angle, g_angle_d)


def cartpole_fast_derivs_vjp(xs: Tuple, us: Tuple, p, lam: Tuple) -> Tuple[Tuple, Tuple]:
    """``cartpole_derivs_vjp`` of the fast plant: the polynomials' values
    and their derivatives S'(r) and C'(r), which ``jax.vjp`` takes through
    ops/fastmath.py (``round`` has a zero gradient)."""
    return cartpole_derivs_vjp(xs, us, p, lam, fast_sincos_d)


def cartpole_fast_derivs_jac(xs: Tuple, us: Tuple, p) -> Tuple[Tuple, torch.Tensor]:
    """``cartpole_derivs_jac`` of the fast plant (as ``cartpole_fast_derivs_vjp``)."""
    return cartpole_derivs_jac(xs, us, p, fast_sincos_d)


def _vjp_from_jac(derivs_jac: Callable, xs: Tuple, us: Tuple, p, lam: Tuple
                  ) -> Tuple[Tuple, Tuple]:
    """``lam^T J`` of a plant's ``(f, J [K, S, S+U]) = derivs_jac(...)``,
    split into the state's and the control's parts."""
    _, J = derivs_jac(xs, us, p)
    g = torch.einsum("ks,ksn->kn", torch.stack(lam, dim=1), J)
    S = len(xs)
    return tuple(g[:, i] for i in range(S)), tuple(g[:, S + j] for j in range(len(us)))


def _jac_rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(row, dim=1) for row in rows], dim=1)


def _tie(v: torch.Tensor) -> torch.Tensor:
    """The derivative of ``maximum(v, 0)`` in v as ``jax.vjp`` takes it: 1
    above 0, 0 below, 1/2 at the tie."""
    return torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0)).to(v.dtype)


def _sin_d(theta, sincos_d):
    sin_t, _, dsin, _ = sincos_d(theta)
    return sin_t, dsin


def pendulum_derivs_jac(xs: Tuple, us: Tuple, p,
                        sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_pendulum_derivs at (x, u), J =
    d f / d(x, u) ``[K, 2, 3]``, over the trig of ``sincos_d``."""
    theta, theta_d = xs
    L = p["d_L"]
    torque = us[0] * p["d_u_max"]
    sin_t, dsin = _sin_d(theta, sincos_d)
    gl = p["d_g"] / L
    inv_ml2 = 1.0 / (p["d_m"] * (L * L))
    theta_dd = gl * sin_t + torque * inv_ml2 - p["d_damping"] * theta_d
    zero = torch.zeros_like(theta)
    rows = ((zero, zero + 1.0, zero),
            (gl * dsin, zero - p["d_damping"], zero + p["d_u_max"] * inv_ml2))
    return (theta_d, theta_dd), _jac_rows(rows)


def acrobot_derivs_jac(xs: Tuple, us: Tuple, p,
                       sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_acrobot_derivs at (x, u), J =
    d f / d(x, u) ``[K, 4, 5]``, over the trig of ``sincos_d``.  With h =
    m2 l1 lc2, the inertia terms d1, d2 depend on theta2 alone (dd1 =
    -2 h ndcos2, dd2 = -h ndcos2), phi2 on theta1 + theta2; t2dd = num /
    den and t1dd = -(d2 t2dd + phi1) / d1 are differentiated by the
    quotient rule."""
    t1, t1d, t2, t2d = xs
    tau = us[0] * p["d_u_max"]
    m1, m2, l1 = p["d_m1"], p["d_m2"], p["d_l1"]
    lc1, lc2, I1, I2, g = p["d_lc1"], p["d_lc2"], p["d_I1"], p["d_I2"], p["d_g"]
    s2, c2, ds2, ndc2 = sincos_d(t2)
    s1, ds1 = _sin_d(t1, sincos_d)
    s12, ds12 = _sin_d(t1 + t2, sincos_d)
    h = m2 * l1 * lc2
    d1 = m1 * (lc1 * lc1) + m2 * (l1 * l1 + lc2 * lc2 + 2.0 * l1 * lc2 * c2) + I1 + I2
    d2 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + I2
    dd1, dd2 = -(2.0 * h * ndc2), -(h * ndc2)
    k2 = m2 * lc2 * g
    k1 = (m1 * lc1 + m2 * l1) * g
    phi2, dphi2 = k2 * s12, k2 * ds12
    phi1 = -h * (t2d * t2d) * s2 - 2.0 * h * t2d * t1d * s2 + k1 * s1 + phi2
    # phi1's partials in t1, t1d, t2, t2d
    f1 = k1 * ds1 + dphi2
    f2 = -(2.0 * h * t2d * s2)
    f3 = -(h * (t2d * t2d) + 2.0 * h * t2d * t1d) * ds2 + dphi2
    f4 = -(2.0 * h * t2d * s2) - 2.0 * h * t1d * s2
    inv_d1 = 1.0 / d1
    r = d2 * inv_d1
    dr = (dd2 - r * dd1) * inv_d1
    num = tau + r * phi1 - h * (t1d * t1d) * s2 - phi2
    inv_den = 1.0 / (m2 * (lc2 * lc2) + I2 - d2 * d2 * inv_d1)
    dden = -(2.0 * r * dd2 - r * r * dd1)
    t2dd = num * inv_den
    t1dd = -(d2 * t2dd + phi1) * inv_d1
    # t2dd's partials
    b1 = (r * f1 - dphi2) * inv_den
    b2 = (r * f2 - 2.0 * h * t1d * s2) * inv_den
    b3 = (dr * phi1 + r * f3 - h * (t1d * t1d) * ds2 - dphi2 - t2dd * dden) * inv_den
    b4 = r * f4 * inv_den
    bu = p["d_u_max"] * inv_den + torch.zeros_like(t1)
    # t1dd's
    a1 = -(d2 * b1 + f1) * inv_d1
    a2 = -(d2 * b2 + f2) * inv_d1
    a3 = -(dd2 * t2dd + d2 * b3 + f3 + t1dd * dd1) * inv_d1
    a4 = -(d2 * b4 + f4) * inv_d1
    au = -(d2 * bu) * inv_d1
    zero, one = torch.zeros_like(t1), torch.ones_like(t1)
    rows = ((zero, one, zero, zero, zero), (a1, a2, a3, a4, au),
            (zero, zero, zero, one, zero), (b1, b2, b3, b4, bu))
    return (t1d, t1dd, t2d, t2dd), _jac_rows(rows)


def pointmass_derivs_jac(xs: Tuple, us: Tuple, p) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:pointmass_derivs_soa, J ``[K, 4,
    6]``: constant (the plant is linear)."""
    _, _, vx, vy = xs
    inv_m = 1.0 / p["d_mass"]
    drag, u_max = p["d_drag"], p["d_u_max"]
    f = (vx, vy, (us[0] * u_max - drag * vx) * inv_m, (us[1] * u_max - drag * vy) * inv_m)
    zero, one = torch.zeros_like(vx), torch.ones_like(vx)
    dv, du = zero - drag * inv_m, zero + u_max * inv_m
    rows = ((zero, zero, one, zero, zero, zero), (zero, zero, zero, one, zero, zero),
            (zero, zero, dv, zero, du, zero), (zero, zero, zero, dv, zero, du))
    return f, _jac_rows(rows)


def pendulum_fast_derivs_jac(xs, us, p):
    return pendulum_derivs_jac(xs, us, p, fast_sincos_d)


def acrobot_fast_derivs_jac(xs, us, p):
    return acrobot_derivs_jac(xs, us, p, fast_sincos_d)


def pendulum_derivs_vjp(xs, us, p, lam):
    return _vjp_from_jac(pendulum_derivs_jac, xs, us, p, lam)


def pendulum_fast_derivs_vjp(xs, us, p, lam):
    return _vjp_from_jac(pendulum_fast_derivs_jac, xs, us, p, lam)


def acrobot_derivs_vjp(xs, us, p, lam):
    return _vjp_from_jac(acrobot_derivs_jac, xs, us, p, lam)


def acrobot_fast_derivs_vjp(xs, us, p, lam):
    return _vjp_from_jac(acrobot_fast_derivs_jac, xs, us, p, lam)


def pointmass_derivs_vjp(xs, us, p, lam):
    return _vjp_from_jac(pointmass_derivs_jac, xs, us, p, lam)


def _no_change(us):
    """The control-change part of a cost without ``ccrc_weight``: none."""
    return tuple(torch.zeros_like(u) for u in us)


def pendulum_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the pendulum/default stage cost
    (costs/pendulum.py); it has no control-change term."""
    angle, angle_d = xs
    m, L, g = p["c_m"], p["c_L"], p["c_g"]
    cos_a, sin_a = angle.cos(), angle.sin()
    mgl = m * g * L
    ml2 = m * (L * L)
    energy = 0.5 * ml2 * (angle_d * angle_d) + mgl * cos_a
    e2 = 2.0 * p["c_energy_weight"] * (energy - mgl)
    vw = p["c_velocity_weight"]
    g_angle = ct * (p["c_angle_weight"] * sin_a - e2 * mgl * sin_a
                    - vw * 0.5 * sin_a * (angle_d * angle_d))
    g_angle_d = ct * (e2 * ml2 * angle_d + vw * (0.5 * (1.0 + cos_a)) * 2.0 * angle_d)
    gu = tuple(ct * 2.0 * p["c_control_weight"] * u for u in us)
    return (g_angle, g_angle_d), gu, _no_change(us)


def acrobot_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the acrobot/default stage cost
    (costs/acrobot.py): ``maximum(height / max_h, 0)``'s tie as
    ``jax.vjp`` takes it."""
    t1, t1d, t2, t2d = xs
    l1, l2 = p["c_l1"], p["c_l2"]
    s12 = (t1 + t2).sin()
    height = -l1 * t1.cos() - l2 * (t1 + t2).cos()
    max_h = l1 + l2
    hm = height / max_h
    top = torch.maximum(hm, torch.zeros_like(hm))
    near_top = top * top
    vw = p["c_velocity_weight"]
    vsum = t1d * t1d + t2d * t2d
    # d stage / d height
    dh = -p["c_height_weight"] + vw * vsum * (2.0 * top * _tie(hm) / max_h)
    g_t2 = ct * dh * (l2 * s12)
    g_t1 = ct * dh * (l1 * t1.sin() + l2 * s12)
    gu = tuple(ct * 2.0 * p["c_control_weight"] * u for u in us)
    return ((g_t1, ct * vw * near_top * 2.0 * t1d, g_t2, ct * vw * near_top * 2.0 * t2d), gu,
            _no_change(us))


def _zero_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    """A cost without a terminal term (pendulum, acrobot)."""
    return tuple(torch.zeros_like(x) for x in xs)


def pointmass_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the pointmass/default stage cost
    (costs/pointmass.py) with its control-change term."""
    x, y, vx, vy = xs
    pw, vw = 2.0 * p["c_pos_weight"], 2.0 * p["c_vel_weight"]
    cc = 2.0 * p["c_cc_weight"] * p["c_R"]
    ccrc = 2.0 * p["c_ccrc_weight"]
    gu, gprev = [], []
    for u, pu in zip(us, prev_us):
        dchange = ct * ccrc * (u - pu)
        gu.append(ct * cc * u + dchange)
        gprev.append(-dchange)
    gx = (ct * pw * (x - p["a_target_x"]), ct * pw * (y - p["a_target_y"]),
          ct * vw * vx, ct * vw * vy)
    return gx, tuple(gu), tuple(gprev)


def pointmass_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    """Gradient of ``ct *`` costs/pointmass.py:terminal_cost_soa."""
    x, y, vx, vy = xs
    pw, vw = 20.0 * p["c_pos_weight"], 2.0 * p["c_vel_weight"]
    return (ct * pw * (x - p["a_target_x"]), ct * pw * (y - p["a_target_y"]),
            ct * vw * vx, ct * vw * vy)


def obstacle_penalty_grad(x, y, p, ct) -> Tuple:
    """Gradient of ``ct *`` costs/obstacles.py:obstacle_penalty in (x, y):
    each hinge ``maximum(0, 1 - d2 / m2)`` with its tie as ``jax.vjp``
    takes it."""
    gx, gy = torch.zeros_like(x), torch.zeros_like(y)
    for i in range(3):
        dx, dy = x - p[f"a_obs{i}_x"], y - p[f"a_obs{i}_y"]
        margin = p[f"a_obs{i}_r"] + p["c_clearance"]
        m2 = margin * margin
        v = 1.0 - (dx * dx + dy * dy) / m2
        hinge = torch.maximum(torch.zeros_like(v), v)
        coef = 2.0 * hinge * _tie(v) * (-2.0 / m2)
        gx, gy = gx + coef * dx, gy + coef * dy
    w = ct * p["c_obstacle_weight"]
    return w * gx, w * gy


def pointmass_obstacle_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the pointmass/obstacles stage cost."""
    gx, gu, gprev = pointmass_stage_vjp(xs, us, prev_us, p, ct)
    ox, oy = obstacle_penalty_grad(xs[0], xs[1], p, ct)
    return (gx[0] + ox, gx[1] + oy, gx[2], gx[3]), gu, gprev


def pointmass_obstacle_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    """Gradient of ``ct *`` the pointmass/obstacles terminal cost."""
    gx = pointmass_terminal_grad(xs, p, ct)
    ox, oy = obstacle_penalty_grad(xs[0], xs[1], p, ct)
    return (gx[0] + ox, gx[1] + oy, gx[2], gx[3])



def quadrotor2d_derivs_jac(xs: Tuple, us: Tuple, p,
                           sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_quadrotor2d_derivs at (x, u), J =
    d f / d(x, u) ``[K, 6, 8]``: the accelerations' rows (2, 3) and the
    pitch acceleration's (5); the others are the unit rows of vx, vz and
    omega."""
    _, _, vx, vz, theta, omega = xs
    u_max = p["d_u_max"]
    t1 = us[0] * u_max
    t2 = us[1] * u_max
    thrust = t1 + t2
    sin_t, cos_t, dsin, ndcos = sincos_d(theta)
    inv_m = 1.0 / p["d_m"]
    drag = p["d_drag"]
    ax = (-thrust * sin_t - drag * vx) * inv_m
    az = (thrust * cos_t - drag * vz) * inv_m - p["d_g"]
    ka = p["d_arm"] / p["d_I"]
    alpha = (t2 - t1) * ka
    zero, one = torch.zeros_like(vx), torch.ones_like(vx)
    dv = zero - drag * inv_m
    ax_u = -(u_max * sin_t) * inv_m
    az_u = u_max * cos_t * inv_m
    al_u = zero + u_max * ka
    rows = ((zero, zero, one, zero, zero, zero, zero, zero),
            (zero, zero, zero, one, zero, zero, zero, zero),
            (zero, zero, dv, zero, -(thrust * dsin) * inv_m, zero, ax_u, ax_u),
            (zero, zero, zero, dv, -(thrust * ndcos) * inv_m, zero, az_u, az_u),
            (zero, zero, zero, zero, zero, one, zero, zero),
            (zero, zero, zero, zero, zero, zero, -al_u, al_u))
    return (vx, vz, ax, az, omega, alpha), _jac_rows(rows)


def secant_clamp_d(c_th):
    """``(c_safe, d c_safe / d c_th)`` of models/dynamics.py's clamped
    secant, ``where(c >= 0, maximum(c, 0.15), minimum(c, -0.15))``, its
    derivative as ``jax.vjp`` takes it: 1 where the clamp passes c, 0 where
    it holds, 1/2 at c = +-0.15 (``maximum``/``minimum`` split a tie), and
    at c = 0 the first branch's (0)."""
    lo, hi = torch.full_like(c_th, -0.15), torch.full_like(c_th, 0.15)
    pos = c_th >= 0.0
    safe = torch.where(pos, torch.maximum(c_th, hi), torch.minimum(c_th, lo))
    d_pos = _tie(c_th - hi)
    d_neg = _tie(lo - c_th)
    return safe, torch.where(pos, d_pos, d_neg)


def quadrotor3d_derivs_jac(xs: Tuple, us: Tuple, p,
                           sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_quadrotor3d_derivs at (x, u), J =
    d f / d(x, u) ``[K, 12, 16]``: rows 3-5 (the world accelerations:
    thrust direction A, B, C of the three angles), 6-8 (the Euler-rate
    kinematics over the clamped secant, ``secant_clamp_d``) and 9-11 (the
    body-rate dynamics); rows 0-2 are the unit rows of the velocities."""
    _, _, _, vx, vy, vz, phi, theta, psi, wp, wq, wr = xs
    u_max = p["d_u_max"]
    t1, t2, t3, t4 = (u * u_max for u in us)
    thrust = t1 + t2 + t3 + t4
    s_ph, c_ph, ds_ph, ndc_ph = sincos_d(phi)
    s_th, c_th, ds_th, ndc_th = sincos_d(theta)
    s_ps, c_ps, ds_ps, ndc_ps = sincos_d(psi)
    inv_m, drag = 1.0 / p["d_m"], p["d_drag"]
    A = c_ph * s_th * c_ps + s_ph * s_ps
    B = c_ph * s_th * s_ps - s_ph * c_ps
    C = c_ph * c_th
    ax = (thrust * A - drag * vx) * inv_m
    ay = (thrust * B - drag * vy) * inv_m
    az = (thrust * C - drag * vz) * inv_m - p["d_g"]
    cs, dcs = secant_clamp_d(c_th)
    dcs = -(dcs * ndc_th)                     # d c_safe / d theta
    tan_th = s_th / cs
    wn = s_ph * wq + c_ph * wr
    phi_d = wp + wn * tan_th
    theta_d = c_ph * wq - s_ph * wr
    psi_d = wn / cs
    Ix, Iy, Iz, arm = p["d_Ix"], p["d_Iy"], p["d_Iz"], p["d_arm"]
    tau_x = arm * (t2 - t4)
    tau_y = arm * (t3 - t1)
    tau_z = p["d_k_yaw"] * (t1 - t2 + t3 - t4)
    wp_d = ((Iy - Iz) * wq * wr + tau_x) / Ix
    wq_d = ((Iz - Ix) * wp * wr + tau_y) / Iy
    wr_d = ((Ix - Iy) * wp * wq + tau_z) / Iz
    f = (vx, vy, vz, ax, ay, az, phi_d, theta_d, psi_d, wp_d, wq_d, wr_d)

    zero = torch.zeros_like(vx)
    J = [[zero] * 16 for _ in range(12)]
    for i in range(3):
        J[i][3 + i] = zero + 1.0
    # the thrust direction's partials in phi, theta, psi
    dA = (ds_ph * s_ps - ndc_ph * s_th * c_ps, c_ph * ds_th * c_ps,
          s_ph * ds_ps - c_ph * s_th * ndc_ps)
    dB = (-(ndc_ph * s_th * s_ps) - ds_ph * c_ps, c_ph * ds_th * s_ps,
          c_ph * s_th * ds_ps + s_ph * ndc_ps)
    dC = (-(ndc_ph * c_th), -(c_ph * ndc_th), zero)
    dv = zero - drag * inv_m
    for i, (d, dir_) in enumerate(((dA, A), (dB, B), (dC, C))):
        J[3 + i][3 + i] = dv
        for a in range(3):
            J[3 + i][6 + a] = thrust * d[a] * inv_m
        for j in range(4):
            J[3 + i][12 + j] = u_max * dir_ * inv_m
    # Euler rates
    dwn = ds_ph * wq - ndc_ph * wr             # d wn / d phi
    dtan = (ds_th - tan_th * dcs) / cs         # d tan / d theta
    J[6][6], J[6][7], J[6][9] = dwn * tan_th, wn * dtan, zero + 1.0
    J[6][10], J[6][11] = s_ph * tan_th, c_ph * tan_th
    J[7][6], J[7][10], J[7][11] = -(ndc_ph * wq) - ds_ph * wr, c_ph, -s_ph
    J[8][6], J[8][7] = dwn / cs, -(psi_d * dcs) / cs
    J[8][10], J[8][11] = s_ph / cs, c_ph / cs
    # body rates
    J[9][10], J[9][11] = (Iy - Iz) * wr / Ix, (Iy - Iz) * wq / Ix
    J[10][9], J[10][11] = (Iz - Ix) * wr / Iy, (Iz - Ix) * wp / Iy
    J[11][9], J[11][10] = (Ix - Iy) * wq / Iz, (Ix - Iy) * wp / Iz
    kx, ky, kz = arm * u_max / Ix, arm * u_max / Iy, p["d_k_yaw"] * u_max / Iz
    J[9][13], J[9][15] = zero + kx, zero - kx
    J[10][14], J[10][12] = zero + ky, zero - ky
    J[11][12], J[11][13], J[11][14], J[11][15] = zero + kz, zero - kz, zero + kz, zero - kz
    return f, _jac_rows(J)


def car_derivs_jac(xs: Tuple, us: Tuple, p,
                   sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_car_derivs at (x, u), J = d f /
    d(x, u) ``[K, 4, 6]``: tan(steer) = s / c differentiated by the
    quotient rule over the trig's own derivatives."""
    _, _, yaw, v = xs
    smax, wb, vmax, drag = p["d_steer_max"], p["d_wheelbase"], p["d_v_max"], p["d_drag"]
    steer = us[0] * smax
    accel = us[1] * p["d_accel_max"]
    s_y, c_y, ds_y, ndc_y = sincos_d(yaw)
    s_d, c_d, ds_d, ndc_d = sincos_d(steer)
    tan_d = s_d / c_d
    r = v / vmax
    f = (v * c_y, v * s_y, v * tan_d / wb, accel - drag * v * (1.0 + r**2))
    dtan = (ds_d * c_d + s_d * ndc_d) / (c_d * c_d)
    zero = torch.zeros_like(v)
    rows = ((zero, zero, -(v * ndc_y), c_y, zero, zero),
            (zero, zero, v * ds_y, s_y, zero, zero),
            (zero, zero, zero, tan_d / wb, v * dtan * smax / wb, zero),
            (zero, zero, zero, -drag * (1.0 + r**2) - drag * v * 2.0 * r / vmax, zero,
             zero + p["d_accel_max"]))
    return f, _jac_rows(rows)


def arm2_derivs_jac(xs: Tuple, us: Tuple, p,
                    sincos_d: Callable = exact_sincos_d) -> Tuple[Tuple, torch.Tensor]:
    """``(f, J)`` for models/dynamics.py:_arm2_derivs at (x, u), J = d f /
    d(x, u) ``[K, 4, 6]``: t1dd = (M22 r1 - M12 r2) / det and t2dd = (M11 r2
    - M12 r1) / det by the quotient rule, the inertia terms depending on
    theta2 alone (dM11 = -2 h ndcos2, dM12 = -h ndcos2)."""
    t1, t1d, t2, t2d = xs
    u_max = p["d_u_max"]
    m1, m2, l1 = p["d_m1"], p["d_m2"], p["d_l1"]
    lc1, lc2, I1, I2, g, b = p["d_lc1"], p["d_lc2"], p["d_I1"], p["d_I2"], p["d_g"], p["d_b"]
    s2, c2, ds2, ndc2 = sincos_d(t2)
    s1, _, ds1, _ = sincos_d(t1)
    s12, _, ds12, _ = sincos_d(t1 + t2)
    h = m2 * l1 * lc2
    M11 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * c2) + I1 + I2
    M12 = m2 * (lc2**2 + l1 * lc2 * c2) + I2
    M22 = m2 * lc2**2 + I2
    dM11, dM12 = -(2.0 * h * ndc2), -(h * ndc2)
    k1, k2 = (m1 * lc1 + m2 * l1) * g, m2 * lc2 * g
    vv = t2d**2 + 2.0 * t1d * t2d
    r1 = us[0] * u_max + h * s2 * vv - (k1 * s1 + k2 * s12) - b * t1d
    r2 = us[1] * u_max - h * s2 * t1d**2 - k2 * s12 - b * t2d
    det = M11 * M22 - M12 * M12
    t1dd = (M22 * r1 - M12 * r2) / det
    t2dd = (M11 * r2 - M12 * r1) / det
    zero = torch.zeros_like(t1)
    # r1's and r2's partials in (t1, t1d, t2, t2d, u1, u2)
    dr1 = (-(k1 * ds1 + k2 * ds12), h * s2 * 2.0 * t2d - b, h * ds2 * vv - k2 * ds12,
           h * s2 * (2.0 * t2d + 2.0 * t1d), zero + u_max, zero)
    dr2 = (-(k2 * ds12), -(h * s2 * 2.0 * t1d), -(h * ds2 * t1d**2) - k2 * ds12, zero - b,
           zero, zero + u_max)
    ddet = dM11 * M22 - 2.0 * M12 * dM12       # d det / d t2
    a, c = [], []
    for n in range(6):
        dn1 = M22 * dr1[n] - M12 * dr2[n]
        dn2 = M11 * dr2[n] - M12 * dr1[n]
        if n == 2:
            dn1 = dn1 - dM12 * r2
            dn2 = dn2 + dM11 * r2 - dM12 * r1
            a.append((dn1 - t1dd * ddet) / det)
            c.append((dn2 - t2dd * ddet) / det)
        else:
            a.append(dn1 / det)
            c.append(dn2 / det)
    one = torch.ones_like(t1)
    rows = ((zero, one, zero, zero, zero, zero), tuple(a),
            (zero, zero, zero, one, zero, zero), tuple(c))
    return (t1d, t1dd, t2d, t2dd), _jac_rows(rows)


def quadrotor2d_fast_derivs_jac(xs, us, p):
    return quadrotor2d_derivs_jac(xs, us, p, fast_sincos_d)


def quadrotor3d_fast_derivs_jac(xs, us, p):
    return quadrotor3d_derivs_jac(xs, us, p, fast_sincos_d)


def car_fast_derivs_jac(xs, us, p):
    return car_derivs_jac(xs, us, p, fast_sincos_d)


def arm2_fast_derivs_jac(xs, us, p):
    return arm2_derivs_jac(xs, us, p, fast_sincos_d)


def _control_grads(us, prev_us, p, ct, cc_of):
    """``(gu, gprev)`` of a stage cost whose control part has the gradient
    ``cc_of(j, u)`` in u_j, plus ``ccrc_weight * (u - prev)^2``."""
    ccrc = 2.0 * p["c_ccrc_weight"]
    gu, gprev = [], []
    for j, (u, pu) in enumerate(zip(us, prev_us)):
        dchange = ct * ccrc * (u - pu)
        gu.append(ct * cc_of(j, u) + dchange)
        gprev.append(-dchange)
    return tuple(gu), tuple(gprev)


def _hover_cc(p):
    cc = 2.0 * p["c_cc_weight"]
    return lambda j, u: cc * (u - p["c_hover_thrust"])


def quadrotor2d_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the quadrotor2d/default stage cost
    (costs/quadrotor2d.py) with its control-change term."""
    x, z, vx, vz, theta, omega = xs
    pw, vw = 2.0 * p["c_pos_weight"], 2.0 * p["c_vel_weight"]
    gx = (ct * pw * (x - p["a_target_x"]), ct * pw * (z - p["a_target_z"]), ct * vw * vx,
          ct * vw * vz, ct * p["c_tilt_weight"] * theta.sin(),
          ct * (2.0 * p["c_rate_weight"]) * omega)
    return (gx, *_control_grads(us, prev_us, p, ct, _hover_cc(p)))


def quadrotor2d_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    x, z, vx, vz, theta, omega = xs
    pw, vw = 20.0 * p["c_pos_weight"], 2.0 * p["c_vel_weight"]
    return (ct * pw * (x - p["a_target_x"]), ct * pw * (z - p["a_target_z"]), ct * vw * vx,
            ct * vw * vz, ct * (10.0 * p["c_tilt_weight"]) * theta.sin(), torch.zeros_like(omega))


def quadrotor3d_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the quadrotor3d/default stage cost
    (costs/quadrotor3d.py) with its control-change term."""
    pw, vw = 2.0 * p["c_pos_weight"], 2.0 * p["c_vel_weight"]
    tw, rw = p["c_tilt_weight"], 2.0 * p["c_rate_weight"]
    targets = (p["a_target_x"], p["a_target_y"], p["a_target_z"])
    gx = (tuple(ct * pw * (xs[i] - targets[i]) for i in range(3))
          + tuple(ct * vw * xs[3 + i] for i in range(3))
          + (ct * tw * xs[6].sin(), ct * tw * xs[7].sin(),
             ct * p["c_yaw_weight"] * (xs[8] - p["a_target_yaw"]).sin())
          + tuple(ct * rw * xs[9 + i] for i in range(3)))
    return (gx, *_control_grads(us, prev_us, p, ct, _hover_cc(p)))


def quadrotor3d_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    pw, vw, tw = 20.0 * p["c_pos_weight"], 2.0 * p["c_vel_weight"], 10.0 * p["c_tilt_weight"]
    targets = (p["a_target_x"], p["a_target_y"], p["a_target_z"])
    zero = torch.zeros_like(xs[0])
    return (tuple(ct * pw * (xs[i] - targets[i]) for i in range(3))
            + tuple(ct * vw * xs[3 + i] for i in range(3))
            + (ct * tw * xs[6].sin(), ct * tw * xs[7].sin(), zero, zero, zero, zero))


def _car_terms_grad(xs: Tuple, p, ct) -> Tuple:
    """Gradient of ``ct *`` costs/car.py:_terms (pos_weight d2 + vel_weight
    near v^2, near = r2 / (r2 + d2)) in (x, y, yaw, v)."""
    x, y, yaw, v = xs
    dx, dy = x - p["a_target_x"], y - p["a_target_y"]
    d2 = dx * dx + dy * dy
    r2 = p["c_arrive_radius"] * p["c_arrive_radius"]
    near = r2 / (r2 + d2)
    vw = p["c_vel_weight"]
    coef = 2.0 * (p["c_pos_weight"] - vw * (v * v) * near / (r2 + d2))
    return (ct * coef * dx, ct * coef * dy, torch.zeros_like(yaw), ct * (2.0 * vw) * near * v)


def car_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the car/default stage cost (costs/car.py):
    steer_weight u0^2 + cc_weight u1^2, the control-change term."""
    w = (2.0 * p["c_steer_weight"], 2.0 * p["c_cc_weight"])
    return (_car_terms_grad(xs, p, ct),
            *_control_grads(us, prev_us, p, ct, lambda j, u: w[j] * u))


def car_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    """Gradient of ``ct *`` 10 * costs/car.py:_terms."""
    return _car_terms_grad(xs, p, 10.0 * ct)


def car_obstacle_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the car/obstacles stage cost."""
    gx, gu, gprev = car_stage_vjp(xs, us, prev_us, p, ct)
    ox, oy = obstacle_penalty_grad(xs[0], xs[1], p, ct)
    return (gx[0] + ox, gx[1] + oy, gx[2], gx[3]), gu, gprev


def car_obstacle_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    """Gradient of ``ct *`` the car/obstacles terminal cost."""
    gx = car_terminal_grad(xs, p, ct)
    ox, oy = obstacle_penalty_grad(xs[0], xs[1], p, ct)
    return (gx[0] + ox, gx[1] + oy, gx[2], gx[3])


def _arm2_pos_grad(t1, t2, p, c):
    """Gradient of ``c * |fingertip - target|^2`` (costs/arm2.py over
    models/dynamics.py:arm2_end_effector) in (theta1, theta2)."""
    l1, l2 = p["c_l1"], p["c_l2"]
    s1, co1, s12, c12 = t1.sin(), t1.cos(), (t1 + t2).sin(), (t1 + t2).cos()
    ex = l1 * s1 + l2 * s12 - p["a_target_x"]
    ey = -l1 * co1 - l2 * c12 - p["a_target_y"]
    g2 = c * (ex * (l2 * c12) + ey * (l2 * s12))
    return c * (ex * (l1 * co1) + ey * (l1 * s1)) + g2, g2


def arm2_stage_vjp(xs: Tuple, us: Tuple, prev_us: Tuple, p, ct):
    """Gradient of ``ct *`` the arm2/default stage cost (costs/arm2.py)
    with its control-change term."""
    t1, t1d, t2, t2d = xs
    g1, g2 = _arm2_pos_grad(t1, t2, p, ct * (2.0 * p["c_pos_weight"]))
    vw = 2.0 * p["c_vel_weight"]
    cc = 2.0 * p["c_cc_weight"] * p["c_R"]
    return ((g1, ct * vw * t1d, g2, ct * vw * t2d),
            *_control_grads(us, prev_us, p, ct, lambda j, u: cc * u))


def arm2_terminal_grad(xs: Tuple, p, ct) -> Tuple:
    t1, t1d, t2, t2d = xs
    g1, g2 = _arm2_pos_grad(t1, t2, p, ct * (20.0 * p["c_pos_weight"]))
    vw = 2.0 * p["c_vel_weight"]
    return (g1, ct * vw * t1d, g2, ct * vw * t2d)


def _vjp_of(derivs_jac: Callable) -> Callable:
    def derivs_vjp(xs, us, p, lam):
        return _vjp_from_jac(derivs_jac, xs, us, p, lam)

    derivs_vjp.__name__ = derivs_jac.__name__.replace("_jac", "_vjp")
    return derivs_vjp


quadrotor2d_derivs_vjp = _vjp_of(quadrotor2d_derivs_jac)
quadrotor2d_fast_derivs_vjp = _vjp_of(quadrotor2d_fast_derivs_jac)
quadrotor3d_derivs_vjp = _vjp_of(quadrotor3d_derivs_jac)
quadrotor3d_fast_derivs_vjp = _vjp_of(quadrotor3d_fast_derivs_jac)
car_derivs_vjp = _vjp_of(car_derivs_jac)
car_fast_derivs_vjp = _vjp_of(car_fast_derivs_jac)
arm2_derivs_vjp = _vjp_of(arm2_derivs_jac)
arm2_fast_derivs_vjp = _vjp_of(arm2_fast_derivs_jac)

# Device plant -> (derivs_vjp, stage_vjp, terminal_grad): the plants whose
# rollout K7 can differentiate.  A fast plant's cost is the exact one: the
# JAX costs call jnp.cos whatever the plant.
PLANT_ADJOINTS = {
    "cartpole": (cartpole_derivs_vjp, cartpole_stage_vjp, cartpole_terminal_grad),
    "cartpole_fast": (cartpole_fast_derivs_vjp, cartpole_stage_vjp, cartpole_terminal_grad),
    "pendulum": (pendulum_derivs_vjp, pendulum_stage_vjp, _zero_terminal_grad),
    "pendulum_fast": (pendulum_fast_derivs_vjp, pendulum_stage_vjp, _zero_terminal_grad),
    "acrobot": (acrobot_derivs_vjp, acrobot_stage_vjp, _zero_terminal_grad),
    "acrobot_fast": (acrobot_fast_derivs_vjp, acrobot_stage_vjp, _zero_terminal_grad),
    "pointmass": (pointmass_derivs_vjp, pointmass_stage_vjp, pointmass_terminal_grad),
    "pointmass_obstacles": (pointmass_derivs_vjp, pointmass_obstacle_stage_vjp,
                            pointmass_obstacle_terminal_grad),
    "quadrotor2d": (quadrotor2d_derivs_vjp, quadrotor2d_stage_vjp, quadrotor2d_terminal_grad),
    "quadrotor2d_fast": (quadrotor2d_fast_derivs_vjp, quadrotor2d_stage_vjp,
                         quadrotor2d_terminal_grad),
    "quadrotor3d": (quadrotor3d_derivs_vjp, quadrotor3d_stage_vjp, quadrotor3d_terminal_grad),
    "quadrotor3d_fast": (quadrotor3d_fast_derivs_vjp, quadrotor3d_stage_vjp,
                         quadrotor3d_terminal_grad),
    "car": (car_derivs_vjp, car_stage_vjp, car_terminal_grad),
    "car_fast": (car_fast_derivs_vjp, car_stage_vjp, car_terminal_grad),
    "car_obstacles": (car_derivs_vjp, car_obstacle_stage_vjp, car_obstacle_terminal_grad),
    "car_obstacles_fast": (car_fast_derivs_vjp, car_obstacle_stage_vjp,
                           car_obstacle_terminal_grad),
    "arm2": (arm2_derivs_vjp, arm2_stage_vjp, arm2_terminal_grad),
    "arm2_fast": (arm2_fast_derivs_vjp, arm2_stage_vjp, arm2_terminal_grad),
}
# Device plant -> its derivs_jac (K7's adjoint: the Jacobians' forward mode).
PLANT_JACOBIANS = {
    "cartpole": cartpole_derivs_jac,
    "cartpole_fast": cartpole_fast_derivs_jac,
    "pendulum": pendulum_derivs_jac,
    "pendulum_fast": pendulum_fast_derivs_jac,
    "acrobot": acrobot_derivs_jac,
    "acrobot_fast": acrobot_fast_derivs_jac,
    "pointmass": pointmass_derivs_jac,
    "pointmass_obstacles": pointmass_derivs_jac,
    "quadrotor2d": quadrotor2d_derivs_jac,
    "quadrotor2d_fast": quadrotor2d_fast_derivs_jac,
    "quadrotor3d": quadrotor3d_derivs_jac,
    "quadrotor3d_fast": quadrotor3d_fast_derivs_jac,
    "car": car_derivs_jac,
    "car_fast": car_fast_derivs_jac,
    "car_obstacles": car_derivs_jac,
    "car_obstacles_fast": car_fast_derivs_jac,
    "arm2": arm2_derivs_jac,
    "arm2_fast": arm2_fast_derivs_jac,
}


def mlp_step_vjp(xs: Tuple, us: Tuple, net, predict_delta: bool,
                 lam: Tuple) -> Tuple[Tuple, Tuple]:
    """``lam^T d x' / d(x, u)`` for the MLP step of ops/neural_rollout.py
    (``x' = x + net([x, u])``, or ``net([x, u])`` unless ``predict_delta``):
    the forward re-run at (x, u) for its activations, then, last to first,
    ``norm_out`` (times std), each layer transposed (``g @ W^T``, after
    tanh' = 1 - a^2 on the hidden layers), ``norm_in`` (over std); the
    delta form adds ``lam`` to the state's part."""
    a = torch.cat([torch.stack(xs, dim=1), torch.stack(us, dim=1)], dim=1)
    if "norm_in_mean" in net:
        a = (a - net["norm_in_mean"]) / net["norm_in_std"]
    n = sum(1 for k in net if k.startswith("w"))
    acts = []
    for i in range(n - 1):
        a = torch.tanh(a @ net[f"w{i}"] + net[f"b{i}"])
        acts.append(a)
    lam_t = torch.stack(lam, dim=1)
    g = lam_t * net["norm_out_std"] if "norm_out_mean" in net else lam_t
    for i in reversed(range(n)):
        if i < n - 1:
            g = g * (1.0 - acts[i] * acts[i])
        g = g @ net[f"w{i}"].T
    if "norm_in_mean" in net:
        g = g / net["norm_in_std"]
    S = len(xs)
    dxs = tuple(g[:, i] for i in range(S))
    if predict_delta:
        dxs = tadd(lam, dxs)
    return dxs, tuple(g[:, S + j] for j in range(len(us)))


def value_mlp_vjp(ops, x: torch.Tensor, ct: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(V(x) [K], ct * dV/dx [K, S])`` of a learned terminal value's tanh
    MLP ``ops = [w0, b0, ..., w_{L-1}, b_{L-1}]`` (``w_i [in, out]``, one
    output) at the states ``x [K, S]``: the forward for its activations,
    then, last layer to first, each layer transposed (``g @ W^T``) and,
    below a hidden layer, tanh' = 1 - a^2; K7's value_spec form's
    arithmetic (csrc/grad_cost_rollout.cu value_forward_vjp)."""
    n = len(ops) // 2
    a, acts = x, []
    for i in range(n):
        a = a @ ops[2 * i] + ops[2 * i + 1]
        if i < n - 1:
            a = torch.tanh(a)
            acts.append(a)
    g = torch.full_like(a, ct)
    for i in reversed(range(n)):
        g = g @ ops[2 * i].T
        if i > 0:
            g = g * (1.0 - acts[i - 1] * acts[i - 1])
    return a[:, 0], g


def _euler_vjp(derivs_vjp, x, u, p, lam, sub_dt):
    # x' = x + sub_dt * f(x, u)
    dx, du = derivs_vjp(x, u, p, tscale(lam, sub_dt))
    return tadd(lam, dx), du


def _rk4_vjp(derivs, derivs_vjp, x, u, p, lam, sub_dt):
    half, dt6 = 0.5 * sub_dt, sub_dt / 6.0
    # The stage states of soa_integrators.py's rk4, recomputed.
    k1 = derivs(x, u, p)
    t2 = tadd(x, tscale(k1, half))
    k2 = derivs(t2, u, p)
    t3 = tadd(x, tscale(k2, half))
    k3 = derivs(t3, u, p)
    t4 = tadd(x, tscale(k3, sub_dt))
    # x' = x + dt6 * ((k1 + 2*k2) + (2*k3 + k4)), transposed last to first.
    gi = tscale(lam, dt6)
    a4, b4 = derivs_vjp(t4, u, p, gi)
    a3, b3 = derivs_vjp(t3, u, p, tadd(tscale(gi, 2.0), tscale(a4, sub_dt)))
    a2, b2 = derivs_vjp(t2, u, p, tadd(tscale(gi, 2.0), tscale(a3, half)))
    a1, b1 = derivs_vjp(x, u, p, tadd(gi, tscale(a2, half)))
    dx = tadd(tadd(tadd(tadd(lam, a4), a3), a2), a1)
    du = tadd(tadd(tadd(b4, b3), b2), b1)
    return dx, du


def integrator_vjp(derivs: Callable, derivs_vjp: Callable, x: Tuple, u: Tuple, p, lam: Tuple,
                   rk4: bool, substeps: int, dt: float) -> Tuple[Tuple, Tuple]:
    """``lam^T d x_{h+1} / d(x_h, u_h)`` for soa_integrators.make_soa_stepper
    (``substeps`` euler or rk4 sub-steps of ``dt / substeps``).  Each
    sub-step's start state is re-integrated from ``x``, last sub-step
    first; the control's gradient is summed over the sub-steps."""
    sub_dt = dt / substeps
    one_sub_step = make_soa_stepper(derivs, "rk4" if rk4 else "euler", sub_dt)
    du = None
    for sub in reversed(range(substeps)):
        xs = x
        for _ in range(sub):
            xs = one_sub_step(xs, u, p)
        if rk4:
            lam, du_s = _rk4_vjp(derivs, derivs_vjp, xs, u, p, lam, sub_dt)
        else:
            lam, du_s = _euler_vjp(derivs_vjp, xs, u, p, lam, sub_dt)
        du = du_s if du is None else tadd(du, du_s)
    return lam, du


def integrator_jac(derivs_jac: Callable, x: Tuple, u: Tuple, p, rk4: bool, substeps: int,
                   dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A, B)``: ``d x_{h+1} / d x_h`` ``[K, S, S]`` and ``d x_{h+1} / d u_h``
    ``[K, S, U]`` for soa_integrators.make_soa_stepper, in forward mode.
    The tangent ``T = d x / d(x_h, u_h)`` starts at ``[I | 0]``; each stage
    takes the tangent of its state (``T + c dk`` of the stage before)
    through the plant's Jacobian, the control's rows being ``[0 | I]``, and
    each sub-step sums the stages' tangents as the state sums the stages
    (``(dk1 + 2 dk2) + (2 dk3 + dk4)`` for rk4)."""
    S, U = len(x), len(u)
    eye = torch.eye(S + U, dtype=x[0].dtype, device=x[0].device)
    K = x[0].shape[0]
    T = eye[:S].expand(K, S, S + U)
    E = eye[S:].expand(K, U, S + U)

    def tangent(J, Tt):
        return J @ torch.cat([Tt, E], dim=1)

    sub_dt = dt / substeps
    half, dt6 = 0.5 * sub_dt, sub_dt / 6.0
    for _ in range(substeps):
        k1, J = derivs_jac(x, u, p)
        d1 = tangent(J, T)
        if not rk4:
            x, T = tadd(x, tscale(k1, sub_dt)), T + sub_dt * d1
            continue
        k2, J = derivs_jac(tadd(x, tscale(k1, half)), u, p)
        d2 = tangent(J, T + half * d1)
        k3, J = derivs_jac(tadd(x, tscale(k2, half)), u, p)
        d3 = tangent(J, T + half * d2)
        k4, J = derivs_jac(tadd(x, tscale(k3, sub_dt)), u, p)
        d4 = tangent(J, T + sub_dt * d3)
        incr = tadd(tadd(k1, tscale(k2, 2.0)), tadd(tscale(k3, 2.0), k4))
        x = tadd(x, tscale(incr, dt6))
        T = T + dt6 * ((d1 + 2.0 * d2) + (2.0 * d3 + d4))
    return T[..., :S], T[..., S:]


def residual_step_vjp(derivs: Callable, derivs_vjp: Callable, x: Tuple, u: Tuple, p, net,
                      lam: Tuple, rk4: bool, substeps: int, dt: float) -> Tuple[Tuple, Tuple]:
    """``lam^T d x' / d(x, u)`` for the residual step ``x' = ode_step(x, u)
    + mlp([x, u])`` (models/residual_predictor.py): the integrator's VJP
    plus the MLP's in absolute form (no delta identity, no norms), summed
    base first on x and on u."""
    dx_base, du_base = integrator_vjp(derivs, derivs_vjp, x, u, p, lam, rk4, substeps, dt)
    dx_res, du_res = mlp_step_vjp(x, u, net, False, lam)
    return tadd(dx_base, dx_res), tadd(du_base, du_res)


def gp_step_vjp(xs: Tuple, us: Tuple, ops, lam: Tuple) -> Tuple[Tuple, Tuple]:
    """``lam^T d x' / d(x, u)`` for the sparse-GP step of ops/gp_rollout.py
    over the precomputed operands ``ops`` (``flatten_gp_weights``):

        an = ([x, u] - in_mean) * inv_in,   g_m = Zs_m . an
        d2_m = max(|an|^2 - 2 g_m + zn2_m, 0),   k_m = var * exp(-0.5 d2_m)
        x' = x + (sum_m alphaT[:, m] k_m) * out_std + out_mean

    transposed: lo = lam * out_std; kbar_m = sum_s lo_s alphaT[s, m];
    d2bar_m = -0.5 kbar_m k_m times the max's derivative (1 above the clip,
    0 below, 1/2 at a tie, as torch.maximum and jnp.maximum split it);
    anbar = sum_m d2bar_m (2 an - 2 Zs_m); abar = anbar * inv_in; dx = lam
    + abar[:S], du = abar[S:]."""
    S = len(xs)
    a = torch.cat([torch.stack(xs, dim=1), torch.stack(us, dim=1)], dim=1)
    an = (a - ops["in_mean"]) * ops["inv_in"]
    raw = torch.sum(an * an, dim=1, keepdim=True) - 2.0 * (an @ ops["Zs"].T) + ops["zn2"]
    k = ops["var"] * torch.exp(-0.5 * torch.maximum(raw, torch.zeros_like(raw)))
    lo = torch.stack(lam, dim=1) * ops["out_std"]
    clip = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
    d2bar = -0.5 * (lo @ ops["alphaT"]) * k * clip                        # [K, M]
    anbar = 2.0 * an * torch.sum(d2bar, dim=1, keepdim=True) - 2.0 * (d2bar @ ops["Zs"])
    abar = anbar * ops["inv_in"]
    return tadd(lam, tuple(abar[:, i] for i in range(S))), tuple(
        abar[:, S + j] for j in range(len(us)))

