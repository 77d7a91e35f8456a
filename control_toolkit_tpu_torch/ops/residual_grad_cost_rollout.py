"""K9: rollout cost under the residual ``"ODE+res"`` model and its
gradient — the counterpart of
control_toolkit_tpu/ops/pallas_grad.py:build_residual_grad_cost_rollout_kernel.

``residual_grad_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N], net)
-> (cost [K], dQ [K,H,U])``: cost is K12's (ops/residual_rollout.py) and
dQ its gradient with respect to Q, so also the gradient of
``sum_k cost_k``.  It is K7's structure (ops/grad_cost_rollout.py) with
the residual step: one forward sweep stores x_0..x_{H-1} and sums the
stage costs; one backward sweep from h = H-1 to 0 re-linearizes step h at
the stored x_h with ``adjoints.residual_step_vjp`` (the integrator's VJP
plus the MLP's in absolute form) and the cost's hand-written adjoints:

    lam_H = d terminal / d x_H * 1/(H+1)
    dQ_h  = (du_step + gu) + gprev_{h+1}     gprev_H = 0
    lam_h = dx_step + gx

The base's constants and the weights get no gradient.  The CUDA kernel is
``csrc/residual_rollout.cu``; ``residual_grad_cost_rollout_plain`` is the
same function in PyTorch.  The wrapper runs the plain version only when
every operand lies on the CPU; for CUDA operands it launches the kernel or
raises.

Its session-row (``slot_keys``, pallas_grad.py:474) form
``residual_grad_cost_rollout_cols`` (the batched-mpc gradient fleets')
takes B sessions' rollouts in one launch: ``s0 [B*K,S]`` and ``Q
[B*K,H,U]`` session by session, each lane reading its rollout's session
row of ``pvec_b [B,N]`` (the session's base constants, ``per_slot_dyn``,
and cost); the residual's weights are shared.  It returns ``(cost [B,K],
dQ [B*K,H,U])``.

Their ``value_spec`` forms ``residual_grad_cost_rollout_value`` and
``residual_grad_cost_rollout_cols_value`` (pallas_grad.py:119-141,
:191-206) add a learned terminal value V, a tanh MLP ``value_ops = [w0,
b0, ...]`` with the value scale folded into its last layer, as K7's and
K8's do (ops/neural_grad_cost_rollout.py): V(x_H) joins the terminal cost
and ``ct * dV/dx_H`` seeds the backward sweep; every session of the
session-row form is under the one V.  Their plain versions are the plain
versions above with ``value_ops``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import ctypes

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS, residual_step_vjp
from control_toolkit_tpu_torch.ops.grad_cost_rollout import plain_grad_loop
from control_toolkit_tpu_torch.ops.neural_rollout import check_shapes
from control_toolkit_tpu_torch.ops.residual_rollout import residual_step_fn


def residual_grad_cost_rollout_plain(model: kernels.ResidualModel, s0: torch.Tensor,
                                     Q: torch.Tensor, pvec: torch.Tensor, net: Dict,
                                     value_ops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch (pallas_grad.py:169-246 over the
    residual step of :495-499); with ``value_ops``, its value_spec form's."""
    derivs_vjp = PLANT_ADJOINTS[model.plant][0]
    p = model.unpack(pvec)

    def step_vjp(xs, us, lam):
        return residual_step_vjp(model.derivs, derivs_vjp, xs, us, p, net, lam,
                                 model.integrator == "rk4", model.intermediate_steps, model.dt)

    return plain_grad_loop(model, s0, Q, pvec, residual_step_fn(model, pvec, net), step_vjp,
                           value_ops)


def residual_grad_cost_rollout(model: kernels.ResidualModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec: torch.Tensor, net: Dict
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: per-rollout cost ``[K]`` and its gradient ``[K,H,U]`` under the
    residual model; see the module docstring."""
    check_shapes("residual_grad_cost_rollout", s0, Q, pvec)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"residual_grad_cost_rollout: no adjoints for the {model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return residual_grad_cost_rollout_plain(model, s0, Q, pvec, net)
    cost, dQ = _launch("residual_grad_cost_rollout", model, s0, Q, pvec, net, s0.shape[0])
    residual_grad_cost_rollout.launches += 1
    return cost, dQ


residual_grad_cost_rollout.launches = 0


def residual_grad_cost_rollout_value(model: kernels.ResidualModel, s0: torch.Tensor,
                                     Q: torch.Tensor, pvec: torch.Tensor, net: Dict, value_ops
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's value_spec form: per-rollout cost ``[K]`` with the learned
    terminal value and its gradient ``[K,H,U]``; see the module docstring."""
    check_shapes("residual_grad_cost_rollout_value", s0, Q, pvec)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"residual_grad_cost_rollout_value: no adjoints for the "
                         f"{model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec, *net.values(), *value_ops):
        return residual_grad_cost_rollout_plain(model, s0, Q, pvec, net, value_ops)
    cost, dQ = _launch("residual_grad_cost_rollout_value", model, s0, Q, pvec, net, s0.shape[0],
                       value_ops)
    residual_grad_cost_rollout_value.launches += 1
    return cost, dQ


residual_grad_cost_rollout_value.launches = 0


def residual_grad_cost_rollout_cols_plain(model: kernels.ResidualModel, s0: torch.Tensor,
                                          Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict,
                                          value_ops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's session-row form in PyTorch: K9's plain version over the B*K
    rollouts, each stepping and scored under its session's row of
    ``pvec_b``; ``(cost [B,K], dQ [B*K,H,U])``; with ``value_ops``, its
    value_spec form's."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, dQ = residual_grad_cost_rollout_plain(model, s0, Q,
                                                kernels.session_rows(pvec_b, K).T, net,
                                                value_ops)
    return cost.reshape(B, K), dQ


def residual_grad_cost_rollout_cols(model: kernels.ResidualModel, s0: torch.Tensor,
                                    Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's session-row form: ``(cost [B,K], dQ [B*K,H,U])`` of B sessions'
    rollouts in one launch; see the module docstring."""
    K = kernels.check_cols_shapes("residual_grad_cost_rollout_cols", s0, Q, pvec_b)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"residual_grad_cost_rollout_cols: no adjoints for the "
                         f"{model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec_b, *net.values()):
        return residual_grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, net)
    cost, dQ = _launch("residual_grad_cost_rollout_cols", model, s0, Q, pvec_b, net, K)
    residual_grad_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


residual_grad_cost_rollout_cols.launches = 0


def residual_grad_cost_rollout_cols_value(model: kernels.ResidualModel, s0: torch.Tensor,
                                          Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict,
                                          value_ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's session-row value_spec form: ``(cost [B,K], dQ [B*K,H,U])`` of B
    sessions' rollouts under one V in one launch; see the module
    docstring."""
    K = kernels.check_cols_shapes("residual_grad_cost_rollout_cols_value", s0, Q, pvec_b)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"residual_grad_cost_rollout_cols_value: no adjoints for the "
                         f"{model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec_b, *net.values(), *value_ops):
        return residual_grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, net, value_ops)
    cost, dQ = _launch("residual_grad_cost_rollout_cols_value", model, s0, Q, pvec_b, net, K,
                       value_ops)
    residual_grad_cost_rollout_cols_value.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


residual_grad_cost_rollout_cols_value.launches = 0


def _launch(name: str, model: kernels.ResidualModel, s0, Q, pvec, net: Dict, ks: int,
            value_ops=None):
    """Check the operands and launch K9 over sessions of ``ks`` rollouts,
    ``pvec``'s rows (with ``value_ops``, its value_spec form); returns
    ``(cost [B*K], dQ)``."""
    args, tensors = model.net_args(net)
    value = None
    if value_ops is not None:
        tensors.update(kernels.value_tensors(value_ops))
        value = ctypes.byref(kernels.value_args(value_ops, s0.shape[-1]))
    device = kernels.check_cuda_operands(name, s0=s0, Q=Q, pvec=pvec, **tensors)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape(name, S, U, K, H, pvec.shape[-1])
    cost = torch.empty(K, dtype=torch.float32, device=device)
    dQ = torch.empty(K, H, U, dtype=torch.float32, device=device)
    # The forward sweep's states, rollout index fastest, as K7's.
    xhist = torch.empty(H, S, K, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().ctt_residual_grad_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), dQ.data_ptr(), xhist.data_ptr(), K, ks, H, *model.step_args(),
            model.max_cost, 1.0 / (H + 1), args, value,
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost, dQ
