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
acrobot and pointmass plants' are written as their Jacobian's two
nontrivial rows (``*_derivs_jac``; the other rows are the unit rows of the
velocities), from which their VJPs contract (``_vjp_from_jac``); their
costs' gradients (``*_stage_vjp``, ``*_terminal_grad``) take a
``maximum``'s tie at 0 as ``jax.vjp`` does, half the cotangent to each
side (``_tie``).
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

