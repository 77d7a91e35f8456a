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

The CUDA kernel is ``csrc/residual_rollout.cu`` (its source note says
what bounds it on the card); ``residual_cost_rollout_plain`` is the same
function in PyTorch.  The wrapper runs the plain version only when every
operand lies on the CPU; for CUDA operands it launches the kernel or
raises.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.neural_rollout import check_shapes, mlp_step, plain_cost_loop
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
    return plain_cost_loop(model, s0, Q, pvec, residual_step_fn(model, pvec, net))


def residual_cost_rollout(model: kernels.ResidualModel, s0: torch.Tensor, Q: torch.Tensor,
                          pvec: torch.Tensor, net: Dict) -> torch.Tensor:
    """K12: per-rollout trajectory cost ``[K]``; see the module docstring."""
    check_shapes("residual_cost_rollout", s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return residual_cost_rollout_plain(model, s0, Q, pvec, net)
    args, tensors = model.net_args(net)
    device = kernels.check_cuda_operands("residual_cost_rollout", s0=s0, Q=Q, pvec=pvec,
                                         **tensors)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape("residual_cost_rollout", S, U, K, H, pvec.numel())
    cost = torch.empty(K, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().ctt_residual_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), K, H, *model.step_args(), model.max_cost, args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, "residual_cost_rollout")
    residual_cost_rollout.launches += 1
    return cost


residual_cost_rollout.launches = 0
