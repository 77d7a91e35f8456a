"""K2: the semi-fused MPPI cost — the counterpart of the semi-fused half of
control_toolkit_tpu/ops/pallas_mppi.py (``make_run.external``, body
``kernel1_ext`` over ``rollout_cost_core``).

``mppi_cost(model, s0 [S], u_nom [H,U], pvec [N], eps [P,U,K], W [P,H],
low [U], high [U], cc_weight, R, NU) -> cost [K]``.  ``eps`` is the
pre-scaled noise at the P inducing points in the layout the kernel reads:
``[P, U, K]``, rollout index fastest, so a warp's loads coalesce.  (The
JAX kernel's tile layout ``[T, U, P*8, C]`` is a TPU artifact; rollout
``k = t*tile + r*C + c`` of it is ``eps[:, :, k]`` here.)  Per rollout and
step, the noise is interpolated from the two inducing points bracketing h
with the weights of ``W`` itself, added to ``u_nom``, clipped, rolled out
and scored with the stage cost plus the MPPI correction cost:

    cost = (sum_h stage + terminal) / (H+1) + sum_h,j cc*(c1*d^2 + R*u*d + c3*u^2)

with c1 = 0.5*(1-1/NU)*R and c3 = 0.5*R; the correction sum is not
averaged (pallas_mppi.py:250).

The CUDA kernel is ``csrc/mppi_cost.cu`` (its source note says what bounds
it on the card); ``mppi_cost_plain`` is the same function in PyTorch, a
loop over h on ``[K]`` tensors.  The wrapper runs the plain version only
when every operand lies on the CPU; for CUDA operands it launches the
kernel or raises.

Its ``emit_terminal`` form (``kernel1_ext_emit``, pallas_mppi.py:277;
``make_cost_run(..., emit_terminal)``, :501) ``mppi_cost_emit`` also
returns the terminal states ``x_H [K, S]``, row k rollout k's, whose cost
is ``cost[k]`` (the JAX kernel's ``[S, ROWS, T*C]`` tiles hold rollout
``t*tile + r*C + c`` at ``[:, r, t*C + c]``); the semi-fused update adds a
learned value terminal's ``V(x_H)/(H+1)`` to the costs before the softmax.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper


def _corr_consts(cc_weight: float, R: float, NU: float):
    """(cc, c1, r, c3), computed in double as the JAX kernel's Python
    floats are."""
    return float(cc_weight), 0.5 * (1.0 - 1.0 / NU) * R, float(R), 0.5 * R


def mppi_controls_plain(eps, W, u_nom, low, high):
    """The perturbations ``d`` and the clipped controls ``u``, each ``[K,
    H, U]``, of the kernels' interpolation (pallas_mppi.py:226-240): step
    h takes the two inducing points bracketing it, the left one moved
    right where its weight in ``W`` has dropped to zero; ``d = W[p0,h] *
    eps[p0] + W[p0+1,h] * eps[p0+1]``, each product and the sum rounded,
    and ``u = clamp(u_nom[h] + d, low, high)``."""
    P, U, K = eps.shape
    H = u_nom.shape[0]
    Wl = W.tolist()
    us, ds = [], []
    p0 = 0
    for h in range(H):
        while p0 + 1 < P and Wl[p0][h] == 0.0:
            p0 += 1
        for j in range(U):
            d = W[p0, h] * eps[p0, j]
            if p0 + 1 < P:
                d = d + W[p0 + 1, h] * eps[p0 + 1, j]
            us.append(torch.clamp(u_nom[h, j] + d, low[j], high[j]))
            ds.append(d)
    return (torch.stack(us, dim=1).reshape(K, H, U), torch.stack(ds, dim=1).reshape(K, H, U))


def mppi_controls_cost_plain(model: kernels.RolloutModel, s0, u, d, pvec, cc_weight: float,
                             R: float, NU: float) -> torch.Tensor:
    """The MPPI cost ``[K]`` of the controls ``u`` and perturbations ``d``
    ``[K, H, U]`` from s0 (pallas_mppi.py:241-274): the rollout's stage and
    terminal costs over H+1 plus the correction summed in h order."""
    return _controls_cost_emit_plain(model, s0, u, d, pvec, cc_weight, R, NU)[0]


def _controls_cost_emit_plain(model, s0, u, d, pvec, cc_weight, R, NU):
    """``mppi_controls_cost_plain``'s cost and the terminal states ``[K, S]``."""
    p = model.unpack(pvec)
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt,
                                model.intermediate_steps)
    cc, c1, r, c3 = _corr_consts(cc_weight, R, NU)
    K, H, U = u.shape
    xs = tuple(s0[i].expand(K) for i in range(s0.shape[0]))
    prev_us = tuple(p[f"__u_prev_{j}"].expand(K) for j in range(U))
    acc = torch.zeros(K, dtype=u.dtype, device=u.device)
    corr = torch.zeros(K, dtype=u.dtype, device=u.device)
    for h in range(H):
        us, dus = tuple(u[:, h, j] for j in range(U)), tuple(d[:, h, j] for j in range(U))
        acc = acc + model.stage(xs, us, prev_us, p)
        for j in range(U):
            corr = corr + cc * (
                c1 * dus[j] * dus[j] + r * us[j] * dus[j] + c3 * us[j] * us[j]
            )
        xs = one_step(xs, us, p)
        prev_us = us
    return (acc + model.terminal(xs, p)) / (H + 1) + corr, torch.stack(xs, dim=1)


def mppi_cost_plain(model: kernels.RolloutModel, s0, u_nom, pvec, eps, W, low, high,
                    cc_weight: float, R: float, NU: float) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (pallas_mppi.py:214-274)."""
    return mppi_cost_emit_plain(model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU)[0]


def mppi_cost_emit_plain(model: kernels.RolloutModel, s0, u_nom, pvec, eps, W, low, high,
                         cc_weight: float, R: float, NU: float):
    """K2's emit_terminal form in PyTorch: ``(cost [K], x_H [K, S])``."""
    u, d = mppi_controls_plain(eps, W, u_nom, low, high)
    return _controls_cost_emit_plain(model, s0, u, d, pvec, cc_weight, R, NU)


def mppi_cost(model: kernels.RolloutModel, s0: torch.Tensor, u_nom: torch.Tensor,
              pvec: torch.Tensor, eps: torch.Tensor, W: torch.Tensor,
              low: torch.Tensor, high: torch.Tensor,
              cc_weight: float, R: float, NU: float) -> torch.Tensor:
    """Per-rollout MPPI cost ``[K]``; see the module docstring."""
    operands = (model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU)
    if kernels.on_cpu(s0, u_nom, pvec, eps, W, low, high):
        _check_shapes("mppi_cost", *operands[1:8])
        return mppi_cost_plain(*operands)
    cost = _launch("mppi_cost", *operands)
    mppi_cost.launches += 1
    return cost


mppi_cost.launches = 0


def mppi_cost_emit(model: kernels.RolloutModel, s0: torch.Tensor, u_nom: torch.Tensor,
                   pvec: torch.Tensor, eps: torch.Tensor, W: torch.Tensor,
                   low: torch.Tensor, high: torch.Tensor,
                   cc_weight: float, R: float, NU: float):
    """K2's emit_terminal form: ``(cost [K], x_H [K, S])``; see the module
    docstring."""
    operands = (model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU)
    if kernels.on_cpu(s0, u_nom, pvec, eps, W, low, high):
        _check_shapes("mppi_cost_emit", *operands[1:8])
        return mppi_cost_emit_plain(*operands)
    x_term = torch.empty(eps.shape[2], s0.shape[0], dtype=torch.float32, device=s0.device)
    cost = _launch("mppi_cost_emit", *operands, x_term=x_term)
    mppi_cost_emit.launches += 1
    return cost, x_term


mppi_cost_emit.launches = 0


def _check_shapes(name, s0, u_nom, pvec, eps, W, low, high) -> None:
    if (s0.ndim != 1 or u_nom.ndim != 2 or eps.ndim != 3 or W.ndim != 2
            or W.shape != (eps.shape[0], u_nom.shape[0])
            or eps.shape[1] != u_nom.shape[1]
            or low.shape != (u_nom.shape[1],) or high.shape != low.shape):
        raise ValueError(
            f"{name}: expected s0 [S], u_nom [H,U], eps [P,U,K], W [P,H], "
            f"low/high [U]; got {tuple(s0.shape)}, {tuple(u_nom.shape)}, "
            f"{tuple(eps.shape)}, {tuple(W.shape)}, {tuple(low.shape)}, {tuple(high.shape)}"
        )


def _launch(name, model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU,
            x_term=None) -> torch.Tensor:
    """Check the operands and launch K2, or, with ``x_term [K, S]``, its
    emit_terminal form, which writes the terminal states there; returns the
    costs ``[K]``."""
    _check_shapes(name, s0, u_nom, pvec, eps, W, low, high)
    kernels.require("K2" if x_term is None else "K2's emit_terminal form", model.plant)
    device = kernels.check_cuda_operands(
        name, s0=s0, u_nom=u_nom, pvec=pvec, eps=eps, W=W, low=low, high=high
    )
    P, U, K = eps.shape
    H = u_nom.shape[0]
    model.check_launch_shape(name, s0.shape[0], U, K, H, pvec.numel())
    cost = torch.empty(K, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_mppi_cost(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), u_nom.data_ptr(),
            pvec.data_ptr(), eps.data_ptr(), W.data_ptr(), low.data_ptr(),
            high.data_ptr(), cost.data_ptr(), None if x_term is None else x_term.data_ptr(),
            K, H, P, *model.step_args(), model.max_cost, *_corr_consts(cc_weight, R, NU),
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost
