"""K12: rollout + trajectory cost under the residual ``"ODE+res"`` model —
the counterpart of
control_toolkit_tpu/ops/pallas_neural.py:build_residual_cost_rollout_kernel.

``residual_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N], net) ->
cost [K]`` with the semantics of K1 (ops/cost_rollout.py): the stage cost
of (x_h, u_h, u_{h-1}) accrues before the step, the terminal cost is taken
at x_H, the sum is divided by H+1, u_{-1} is the packed ``__u_prev_*``.
The step is models/residual_predictor.py's, in the JAX order:

    x' = ode_step(x, u) + mlp([x, u])

the base's euler/rk4 step over its packed constants (``pvec``'s ``d_*``
part, read as K1 reads it), then the residual MLP (``net``: ``w{i}`` [in,
out], ``b{i}``, tanh on all but the last layer, no norms, absolute form)
on the step's start state.  The net's tensors go to the kernel as they are
stored: a sysid install is a new pointer, never a rebuild.

Its session-row (``slot_keys``) form ``residual_cost_rollout_cols`` (the
batched-mpc fleet's) scores B sessions' rollouts in one launch of the same
kernel, rollout b*K + k reading row b of ``pvec_b [B,N]``: each session's
base constants (``per_slot_dyn``) and cost; the residual's weights are
shared.

Its ``emit_terminal`` form (pallas_neural.py:367), ``residual_cost_rollout_emit``
and its session-row form ``residual_cost_rollout_cols_emit``, also returns
the terminal states ``x_H`` in the costs' rollout order (``[K, S]``; ``[B,
K, S]``), on which a learned value terminal is evaluated outside the
kernel; its costs are K12's, the same body.

The CUDA kernel is ``csrc/residual_rollout.cu`` (its source note says
what bounds it on the card); ``residual_cost_rollout_plain`` is the same
function in PyTorch, the first output of the emit form's plain version.
A wrapper runs its plain version only when every operand lies on the CPU;
for CUDA operands it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.neural_rollout import (
    check_cols_shapes, check_shapes, mlp_step, plain_cost_emit_loop, session_rows,
)
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper


def residual_step_fn(model: kernels.ResidualModel, pvec: torch.Tensor,
                     net: Dict) -> Callable:
    """``step(x [K,S], u [K,U]) -> x'``: the base's step plus the residual."""
    p = model.unpack(pvec)
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt,
                                model.intermediate_steps)

    def step(x, u):
        xb = one_step(tuple(x.unbind(1)), tuple(u.unbind(1)), p)
        return torch.stack(xb, dim=1) + mlp_step(net, x, u, predict_delta=False)

    return step


def residual_cost_rollout_plain(model: kernels.ResidualModel, s0: torch.Tensor,
                                Q: torch.Tensor, pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K12's arithmetic in PyTorch (pallas_neural.py:388-421)."""
    return residual_cost_rollout_emit_plain(model, s0, Q, pvec, net)[0]


def residual_cost_rollout_emit_plain(model: kernels.ResidualModel, s0: torch.Tensor,
                                     Q: torch.Tensor, pvec: torch.Tensor, net: Dict):
    """K12's emit_terminal form in PyTorch: ``(cost [K], x_H [K, S])``."""
    return plain_cost_emit_loop(model, s0, Q, pvec, residual_step_fn(model, pvec, net))


def residual_cost_rollout(model: kernels.ResidualModel, s0: torch.Tensor, Q: torch.Tensor,
                          pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K12: per-rollout trajectory cost ``[K]``; see the module docstring."""
    check_shapes("residual_cost_rollout", s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return residual_cost_rollout_plain(model, s0, Q, pvec, net)
    cost = _launch("residual_cost_rollout", model, s0, Q, pvec, net, s0.shape[0])
    residual_cost_rollout.launches += 1
    return cost


residual_cost_rollout.launches = 0


def residual_cost_rollout_emit(model: kernels.ResidualModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec: torch.Tensor, net: Dict):
    """K12's emit_terminal form: ``(cost [K], x_H [K, S])``; see the
    module docstring."""
    check_shapes("residual_cost_rollout_emit", s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return residual_cost_rollout_emit_plain(model, s0, Q, pvec, net)
    x_term = torch.empty_like(s0)
    cost = _launch("residual_cost_rollout_emit", model, s0, Q, pvec, net, s0.shape[0], x_term)
    residual_cost_rollout_emit.launches += 1
    return cost, x_term


residual_cost_rollout_emit.launches = 0


def residual_cost_rollout_cols_plain(model: kernels.ResidualModel, s0: torch.Tensor,
                                     Q: torch.Tensor, pvec_b: torch.Tensor,
                                     net: Dict) -> torch.Tensor:
    """K12's session-row form in PyTorch: K12's plain version over the B*K
    rollouts, each stepping and scored under its session's row of
    ``pvec_b`` (its base constants and its cost's); ``[B, K]``."""
    return residual_cost_rollout_cols_emit_plain(model, s0, Q, pvec_b, net)[0]


def residual_cost_rollout_cols_emit_plain(model: kernels.ResidualModel, s0: torch.Tensor,
                                          Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict):
    """K12's session-row emit_terminal form in PyTorch: ``(cost [B, K],
    x_H [B, K, S])``."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, x = residual_cost_rollout_emit_plain(model, s0, Q, session_rows(pvec_b, K).T, net)
    return cost.reshape(B, K), x.reshape(B, K, -1)


def residual_cost_rollout_cols(model: kernels.ResidualModel, s0: torch.Tensor,
                               Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict) -> torch.Tensor:
    """K12's session-row (``slot_keys``) form: the costs ``[B, K]`` of B
    sessions' rollouts in one launch, ``s0 [B*K,S]`` and ``Q [B*K,H,U]``
    session by session, rollout b*K + k reading session b's row of
    ``pvec_b [B,N]``: each session plans against its own base constants
    (``per_slot_dyn``); the residual's weights are shared."""
    K = check_cols_shapes("residual_cost_rollout_cols", s0, Q, pvec_b)
    if kernels.on_cpu(s0, Q, pvec_b, *net.values()):
        return residual_cost_rollout_cols_plain(model, s0, Q, pvec_b, net)
    cost = _launch("residual_cost_rollout_cols", model, s0, Q, pvec_b, net, K)
    residual_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K)


residual_cost_rollout_cols.launches = 0


def residual_cost_rollout_cols_emit(model: kernels.ResidualModel, s0: torch.Tensor,
                                    Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict):
    """K12's session-row form's emit_terminal form: ``(cost [B, K], x_H
    [B, K, S])`` of B sessions' rollouts in one launch, laid out as
    ``residual_cost_rollout_cols``'."""
    K = check_cols_shapes("residual_cost_rollout_cols_emit", s0, Q, pvec_b)
    if kernels.on_cpu(s0, Q, pvec_b, *net.values()):
        return residual_cost_rollout_cols_emit_plain(model, s0, Q, pvec_b, net)
    x_term = torch.empty_like(s0)
    cost = _launch("residual_cost_rollout_cols_emit", model, s0, Q, pvec_b, net, K, x_term)
    residual_cost_rollout_cols_emit.launches += 1
    B = pvec_b.shape[0]
    return cost.reshape(B, K), x_term.reshape(B, K, -1)


residual_cost_rollout_cols_emit.launches = 0


def _launch(name: str, model: kernels.ResidualModel, s0, Q, pvec, net, ks: int, x_term=None):
    """Check the operands and launch K12 over sessions of ``ks`` rollouts,
    ``pvec``'s rows, or, with ``x_term [K, S]``, its emit_terminal form,
    which writes the terminal states there; returns the costs."""
    args, tensors = model.net_args(net)
    terminal = {} if x_term is None else {"x_term": x_term}
    device = kernels.check_cuda_operands(name, s0=s0, Q=Q, pvec=pvec, **terminal, **tensors)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape(name, S, U, K, H, pvec.shape[-1])
    cost = torch.empty(K, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().ctt_residual_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), None if x_term is None else x_term.data_ptr(), K, ks, H,
            *model.step_args(), model.max_cost, args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost
