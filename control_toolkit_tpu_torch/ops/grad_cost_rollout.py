"""K7: rollout cost and its gradient — the counterpart of
control_toolkit_tpu/ops/pallas_grad.py:build_grad_cost_rollout_kernel
(body ``_make_fwd_bwd_kernel``, runner ``_make_grad_runner``).

``grad_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N]) -> (cost [K],
dQ [K,H,U])``: cost is K1's trajectory cost (ops/cost_rollout.py) and dQ
its gradient with respect to Q.  Rollouts are independent, so dQ is also
the gradient of ``sum_k cost_k``, which the population optimizers take.

One forward sweep stores the states x_0..x_{H-1} and sums the stage
costs; one backward sweep from h = H-1 to 0 re-linearizes step h at the
stored x_h with the hand-written adjoints of ops/adjoints.py:

    lam_H = d terminal / d x_H * 1/(H+1)
    dQ_h  = (du_dyn + gu) + gprev_{h+1}     gprev_H = 0
    lam_h = dx_dyn + gx

where (dx_dyn, du_dyn) is the integrator's VJP of lam_{h+1}, and (gx, gu,
gprev_h) the stage cost's gradient at cotangent 1/(H+1); ``gprev`` carries
u_h's part in stage h+1's control-change term.  At h = 0 the previous
control is the packed ``__u_prev_*``, which gets no gradient.

The CUDA kernel is ``csrc/grad_cost_rollout.cu``, in two launches (its
source note says what bounds them on the card): the forward stores the
states x_0..x_H; the time-parallel adjoint computes each step's Jacobians
``A_h = d x_{h+1} / d x_h``, ``B_h = d x_{h+1} / d u_h`` (forward mode,
ops/adjoints.py ``integrator_jac``) and stage terms for all (k, h) at
once, then runs the linear chain ``lam_h = A_h^T lam_{h+1} + gx_h``,
``dQ_h = (B_h^T lam_{h+1} + gu_h) + gprev_{h+1}``: the same map as the
sweep above, summed in another order.  ``grad_cost_rollout_plain`` is
the sweep in PyTorch.  The wrapper runs the plain version only when every
operand lies on the CPU; for CUDA operands it launches the kernel or
raises.

Its session-row (``slot_keys``, pallas_grad.py:348) form
``grad_cost_rollout_cols`` (the batched-mpc gradient fleets') takes B
sessions' rollouts in one pair of launches: ``s0 [B*K,S]`` and ``Q
[B*K,H,U]`` session by session, rollout b*K + k reading row b of ``pvec_b
[B,N]`` in both launches; it returns ``(cost [B,K], dQ [B*K,H,U])``.

Its ``value_spec`` form (pallas_grad.py:119-141, :186-200)
``grad_cost_rollout_value(model, s0, Q, pvec, value_ops)`` adds a learned
terminal value V, a tanh MLP ``value_ops = [w0, b0, ...]`` (``w_i [in,
out]``, the value scale folded into the last layer:
``Optimizer._flatten_value_ops``):

    cost  = (acc + terminal(x_H) + V(x_H)) / (H+1)
    lam_H = ct * (d terminal / d x_H + dV / d x_H)

Its forward launch evaluates V and its VJP (ops/adjoints.py
``value_mlp_vjp`` in the plain version, ``grad_cost_rollout_plain``'s
``value_ops``) at x_H and writes ``ct * dV/dx_H`` to a ``[S, K]``
buffer, which its adjoint launch adds to lam_H; the net's tensors go in by
pointer on every call, so a re-fit rebuilds nothing.  Its session-row
form ``grad_cost_rollout_cols_value`` (``slot_keys`` + ``value_spec``,
the valued gradient fleets') takes ``grad_cost_rollout_cols``' operands
and ``value_ops``, every session under the one V.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS, integrator_vjp, value_mlp_vjp
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper, tadd


def plain_grad_loop(model, s0: torch.Tensor, Q: torch.Tensor, pvec: torch.Tensor,
                    step: Callable, step_vjp: Callable,
                    value_ops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient kernels' forward-store / backward-sweep in PyTorch
    (pallas_grad.py:169-244) over any ``step(x [K,S], u [K,U]) -> x'`` and
    its adjoint ``step_vjp(xs, us, lam) -> (dxs, dus)`` in component form,
    with the plant's cost adjoints and, with ``value_ops``, a learned
    terminal value (the value_spec form); returns (cost [K], dQ [K,H,U])."""
    _, stage_vjp, terminal_grad = PLANT_ADJOINTS[model.plant]
    p = model.unpack(pvec)
    K, H, U = s0.shape[0], Q.shape[1], Q.shape[2]
    ct = 1.0 / (H + 1)

    x = s0
    u_prev0 = tuple(p[f"__u_prev_{j}"].expand(K) for j in range(U))
    prev_us, acc, history = u_prev0, torch.zeros(K, dtype=s0.dtype, device=s0.device), []
    for h in range(H):
        history.append(tuple(x.unbind(1)))
        us = tuple(Q[:, h, :].unbind(1))
        acc = acc + model.stage(history[h], us, prev_us, p)
        x = step(x, Q[:, h, :])
        prev_us = us
    xs = tuple(x.unbind(1))
    if value_ops is None:
        cost = (acc + model.terminal(xs, p)) / (H + 1)
        lam = terminal_grad(xs, p, ct)
    else:
        v, dv = value_mlp_vjp(value_ops, x, ct)
        cost = (acc + (model.terminal(xs, p) + v)) / (H + 1)
        lam = tadd(terminal_grad(xs, p, ct), tuple(dv.unbind(1)))
    gprev = tuple(torch.zeros_like(acc) for _ in range(U))
    dq = [None] * H
    for h in reversed(range(H)):
        us = tuple(Q[:, h, :].unbind(1))
        prev_us = u_prev0 if h == 0 else tuple(Q[:, h - 1, :].unbind(1))
        dxs, dus = step_vjp(history[h], us, lam)
        gx, gu, gp = stage_vjp(history[h], us, prev_us, p, ct)
        dq[h] = torch.stack(tadd(tadd(dus, gu), gprev), dim=1)
        lam = tadd(dxs, gx)
        gprev = gp
    return cost, torch.stack(dq, dim=1)


def grad_cost_rollout_plain(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                            pvec: torch.Tensor, value_ops=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch (pallas_grad.py:169-244); with
    ``value_ops``, its value_spec form's."""
    derivs_vjp = PLANT_ADJOINTS[model.plant][0]
    p = model.unpack(pvec)
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt,
                                model.intermediate_steps)

    def step(x, u):
        return torch.stack(one_step(tuple(x.unbind(1)), tuple(u.unbind(1)), p), dim=1)

    def step_vjp(xs, us, lam):
        return integrator_vjp(model.derivs, derivs_vjp, xs, us, p, lam,
                              model.integrator == "rk4", model.intermediate_steps, model.dt)

    return plain_grad_loop(model, s0, Q, pvec, step, step_vjp, value_ops)


def _check_single(name: str, model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                  pvec: torch.Tensor) -> None:
    if s0.ndim != 2 or Q.ndim != 3 or Q.shape[0] != s0.shape[0] or pvec.ndim != 1:
        raise ValueError(
            f"{name}: expected s0 [K,S], Q [K,H,U], pvec [N]; got "
            f"{tuple(s0.shape)}, {tuple(Q.shape)}, {tuple(pvec.shape)}"
        )
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"{name}: no adjoints for the {model.plant!r} plant")


def grad_cost_rollout(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                      pvec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rollout cost ``[K]`` and its gradient ``[K,H,U]``; see the
    module docstring."""
    _check_single("grad_cost_rollout", model, s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec):
        return grad_cost_rollout_plain(model, s0, Q, pvec)
    cost, dQ = _launch("grad_cost_rollout", model, s0, Q, pvec, s0.shape[0])
    grad_cost_rollout.launches += 1
    return cost, dQ


grad_cost_rollout.launches = 0


def grad_cost_rollout_value(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                            pvec: torch.Tensor, value_ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's value_spec form: per-rollout cost ``[K]`` with the learned
    terminal value and its gradient ``[K,H,U]``; see the module docstring.
    Its plain version is ``grad_cost_rollout_plain(..., value_ops)``."""
    _check_single("grad_cost_rollout_value", model, s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *value_ops):
        return grad_cost_rollout_plain(model, s0, Q, pvec, value_ops)
    cost, dQ = _launch("grad_cost_rollout_value", model, s0, Q, pvec, s0.shape[0], value_ops)
    grad_cost_rollout_value.launches += 1
    return cost, dQ


grad_cost_rollout_value.launches = 0


def grad_cost_rollout_cols_plain(model: kernels.RolloutModel, s0: torch.Tensor,
                                 Q: torch.Tensor, pvec_b: torch.Tensor, value_ops=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's session-row form in PyTorch: K7's plain version over the B*K
    rollouts, each under its session's row of ``pvec_b``; ``(cost [B,K],
    dQ [B*K,H,U])``; with ``value_ops``, its value_spec form's."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, dQ = grad_cost_rollout_plain(model, s0, Q, kernels.session_rows(pvec_b, K).T,
                                       value_ops)
    return cost.reshape(B, K), dQ


def grad_cost_rollout_cols(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                           pvec_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's session-row form: ``(cost [B,K], dQ [B*K,H,U])`` of B sessions'
    rollouts in one forward and one adjoint launch; see the module
    docstring."""
    K = kernels.check_cols_shapes("grad_cost_rollout_cols", s0, Q, pvec_b)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"grad_cost_rollout_cols: no adjoints for the {model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec_b):
        return grad_cost_rollout_cols_plain(model, s0, Q, pvec_b)
    cost, dQ = _launch("grad_cost_rollout_cols", model, s0, Q, pvec_b, K)
    grad_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


grad_cost_rollout_cols.launches = 0


def grad_cost_rollout_cols_value(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                                 pvec_b: torch.Tensor, value_ops
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's session-row value_spec form: ``(cost [B,K], dQ [B*K,H,U])`` of
    B sessions' rollouts under one V in one forward and one adjoint
    launch; see the module docstring."""
    K = kernels.check_cols_shapes("grad_cost_rollout_cols_value", s0, Q, pvec_b)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"grad_cost_rollout_cols_value: no adjoints for the {model.plant!r} "
                         "plant")
    if kernels.on_cpu(s0, Q, pvec_b, *value_ops):
        return grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, value_ops)
    cost, dQ = _launch("grad_cost_rollout_cols_value", model, s0, Q, pvec_b, K, value_ops)
    grad_cost_rollout_cols_value.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


grad_cost_rollout_cols_value.launches = 0


# Each wrapper's kernel form (ops/kernels.py KERNEL_PLANTS).
FORMS = {"grad_cost_rollout": "K7", "grad_cost_rollout_value": "K7's value_spec form",
         "grad_cost_rollout_cols": "K7's session-row form",
         "grad_cost_rollout_cols_value": "K7's session-row value_spec form"}


def _launch(name: str, model: kernels.RolloutModel, s0, Q, pvec, ks: int, value_ops=None):
    """Check the operands and launch K7's forward and adjoint over sessions
    of ``ks`` rollouts, ``pvec``'s rows (with ``value_ops``, their
    value_spec instances); returns ``(cost [B*K], dQ)``."""
    kernels.require(FORMS[name], model.plant)
    device = kernels.check_cuda_operands(name, s0=s0, Q=Q, pvec=pvec,
                                         **kernels.value_tensors(value_ops or ()))
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape(name, S, U, K, H, pvec.shape[-1])
    cost = torch.empty(K, dtype=torch.float32, device=device)
    dQ = torch.empty(K, H, U, dtype=torch.float32, device=device)
    # The forward's states x_0..x_H, rollout index fastest (csrc note).
    xhist = torch.empty(H + 1, S, K, dtype=torch.float32, device=device)
    value = None
    if value_ops is not None:
        value = (kernels.value_args(value_ops, S),
                 torch.empty(S, K, dtype=torch.float32, device=device))
    for part in ("forward", "adjoint"):
        launch_part(part, model, s0, Q, pvec, cost, dQ, xhist, ks, value)
    return cost, dQ


def launch_part(part: str, model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                pvec: torch.Tensor, cost: torch.Tensor, dQ: torch.Tensor,
                xhist: torch.Tensor, ks: int = 0, value=None) -> None:
    """One of K7's two launches on checked CUDA operands over sessions of
    ``ks`` rollouts (0: one session), ``pvec``'s rows: ``forward`` (writes
    cost and xhist [H+1, S, K]) or ``adjoint`` (reads xhist, writes dQ);
    with ``value = (ValueArgs, vgrad [S, K])``, of the value_spec form: its
    forward also writes vgrad, its adjoint reads it."""
    K, H = Q.shape[0], Q.shape[1]
    lib, device, ct = kernels.load(), s0.device, 1.0 / (H + 1)
    plant = kernels.PLANT_IDS[model.plant]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if part == "forward" and value is not None:
            rc = lib.ctt_grad_cost_forward_value(
                plant, s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(), cost.data_ptr(),
                xhist.data_ptr(), value[1].data_ptr(), K, ks or K, H, *model.step_args(),
                model.max_cost, ct, ctypes.byref(value[0]), stream)
        elif part == "forward":
            rc = lib.ctt_grad_cost_forward(
                plant, s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
                cost.data_ptr(), xhist.data_ptr(), K, ks or K, H, *model.step_args(),
                model.max_cost, stream)
        else:
            rc = lib.ctt_grad_cost_adjoint(
                plant, Q.data_ptr(), pvec.data_ptr(), xhist.data_ptr(),
                None if value is None else value[1].data_ptr(), dQ.data_ptr(), K, ks or K, H,
                *model.step_args(), ct, stream)
    kernels.check_launch(rc, f"grad_cost_rollout ({part})")
