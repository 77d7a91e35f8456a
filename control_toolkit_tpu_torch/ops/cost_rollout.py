"""K1: rollout + trajectory cost — the counterpart of
control_toolkit_tpu/ops/pallas_rollout.py:build_cost_rollout_kernel.

``cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N]) -> cost [K]`` with
cost = (sum_h stage(x_h, u_h, u_{h-1}) + terminal(x_H)) / (H+1) and
u_{-1} = the packed ``__u_prev_*``.  Q is taken pre-clipped.

The CUDA kernel is ``csrc/cost_rollout.cu``: one thread per rollout, its
state in registers, stepping with ``csrc/short_step.cuh`` (K5's and K6's
step) and loading each step's next control ahead; its source note says
what bounds it on the card.  ``cost_rollout_plain`` is the same
function in PyTorch, a loop over h on ``[K]`` tensors.  The wrapper runs
the plain version only when every operand lies on the CPU; for CUDA
operands it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper


def cost_rollout_plain(model: kernels.RolloutModel, s0: torch.Tensor,
                       Q: torch.Tensor, pvec: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (pallas_rollout.py:75-99)."""
    p = model.unpack(pvec)
    one_step = make_soa_stepper(model.derivs, model.integrator, model.dt,
                                model.intermediate_steps)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    xs = tuple(s0[:, i] for i in range(S))
    prev_us = tuple(p[f"__u_prev_{j}"].expand(K) for j in range(U))
    acc = torch.zeros(K, dtype=s0.dtype, device=s0.device)
    for h in range(H):
        us = tuple(Q[:, h, j] for j in range(U))
        acc = acc + model.stage(xs, us, prev_us, p)
        xs = one_step(xs, us, p)
        prev_us = us
    return (acc + model.terminal(xs, p)) / (H + 1)


def cost_rollout(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                 pvec: torch.Tensor) -> torch.Tensor:
    """Per-rollout trajectory cost ``[K]``; see the module docstring."""
    if s0.ndim != 2 or Q.ndim != 3 or Q.shape[0] != s0.shape[0] or pvec.ndim != 1:
        raise ValueError(
            f"cost_rollout: expected s0 [K,S], Q [K,H,U], pvec [N]; got "
            f"{tuple(s0.shape)}, {tuple(Q.shape)}, {tuple(pvec.shape)}"
        )
    if kernels.on_cpu(s0, Q, pvec):
        return cost_rollout_plain(model, s0, Q, pvec)
    device = kernels.check_cuda_operands("cost_rollout", s0=s0, Q=Q, pvec=pvec)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape("cost_rollout", S, U, K, H, pvec.numel())
    cost = torch.empty(K, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(),
            pvec.data_ptr(), cost.data_ptr(), K, H, *model.step_args(),
            model.max_cost, torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, "cost_rollout")
    cost_rollout.launches += 1
    return cost


cost_rollout.launches = 0
