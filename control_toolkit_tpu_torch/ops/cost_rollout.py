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

Its session-row (``slot_keys``, pallas_rollout.py:47) form
``cost_rollout_cols`` (the batched-mpc gradient fleets' and the modular
batched CEM step's) scores B sessions' rollouts in one launch of the same
kernel: ``s0 [B*K,S]`` and ``Q [B*K,H,U]`` session by session, rollout
b*K + k reading row b of ``pvec_b [B,N]`` (``optimizers/base.py:
make_slot_packer``: the session's attributes, previous control and
``per_slot_dyn`` constants); the costs come back ``[B, K]``.

Its ``emit_terminal`` form (pallas_rollout.py:48, :100, :137-148)
``cost_rollout_emit`` also returns the terminal states ``x_H [K, S]`` in
the costs' rollout order, on which a learned value terminal is evaluated
outside the kernel (``costs/value_terminal.py``); its costs are K1's, the
same body.  Its session-row form ``cost_rollout_cols_emit`` (``slot_keys``
+ ``emit_terminal``, pallas_rollout.py:47-48: the valued gradient fleets'
final scoring over an ODE) returns ``(cost [B, K], x_H [B, K, S])``.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper


def cost_rollout_plain(model: kernels.RolloutModel, s0: torch.Tensor,
                       Q: torch.Tensor, pvec: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (pallas_rollout.py:75-99)."""
    return cost_rollout_emit_plain(model, s0, Q, pvec)[0]


def cost_rollout_emit_plain(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                            pvec: torch.Tensor):
    """K1's emit_terminal form in PyTorch: ``(cost [K], x_H [K, S])``."""
    p = model.unpack(pvec)  # [N], or [N, K]: a row per rollout
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
    return (acc + model.terminal(xs, p)) / (H + 1), torch.stack(xs, dim=1)


def _check_single(name: str, s0: torch.Tensor, Q: torch.Tensor, pvec: torch.Tensor) -> None:
    if s0.ndim != 2 or Q.ndim != 3 or Q.shape[0] != s0.shape[0] or pvec.ndim != 1:
        raise ValueError(
            f"{name}: expected s0 [K,S], Q [K,H,U], pvec [N]; got "
            f"{tuple(s0.shape)}, {tuple(Q.shape)}, {tuple(pvec.shape)}"
        )


def cost_rollout(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                 pvec: torch.Tensor) -> torch.Tensor:
    """Per-rollout trajectory cost ``[K]``; see the module docstring."""
    _check_single("cost_rollout", s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec):
        return cost_rollout_plain(model, s0, Q, pvec)
    cost = _launch("cost_rollout", model, s0, Q, pvec, s0.shape[0])
    cost_rollout.launches += 1
    return cost


cost_rollout.launches = 0


def cost_rollout_emit(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                      pvec: torch.Tensor):
    """K1's emit_terminal form: ``(cost [K], x_H [K, S])``; see the module
    docstring."""
    _check_single("cost_rollout_emit", s0, Q, pvec)
    if kernels.on_cpu(s0, Q, pvec):
        return cost_rollout_emit_plain(model, s0, Q, pvec)
    x_term = torch.empty_like(s0)
    cost = _launch("cost_rollout_emit", model, s0, Q, pvec, s0.shape[0], x_term)
    cost_rollout_emit.launches += 1
    return cost, x_term


cost_rollout_emit.launches = 0


def cost_rollout_cols_plain(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                            pvec_b: torch.Tensor) -> torch.Tensor:
    """K1's session-row form in PyTorch: K1's plain version over the B*K
    rollouts, each stepping and scored under its session's row of
    ``pvec_b``; ``[B, K]``."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    return cost_rollout_plain(model, s0, Q, kernels.session_rows(pvec_b, K).T).reshape(B, K)


def cost_rollout_cols_emit_plain(model: kernels.RolloutModel, s0: torch.Tensor,
                                 Q: torch.Tensor, pvec_b: torch.Tensor):
    """K1's session-row emit_terminal form in PyTorch: ``(cost [B, K], x_H
    [B, K, S])``."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, x = cost_rollout_emit_plain(model, s0, Q, kernels.session_rows(pvec_b, K).T)
    return cost.reshape(B, K), x.reshape(B, K, -1)


def cost_rollout_cols(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                      pvec_b: torch.Tensor) -> torch.Tensor:
    """K1's session-row form: the costs ``[B, K]`` of B sessions' rollouts
    in one launch; see the module docstring."""
    K = kernels.check_cols_shapes("cost_rollout_cols", s0, Q, pvec_b)
    if kernels.on_cpu(s0, Q, pvec_b):
        return cost_rollout_cols_plain(model, s0, Q, pvec_b)
    cost = _launch("cost_rollout_cols", model, s0, Q, pvec_b, K)
    cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K)


cost_rollout_cols.launches = 0


def cost_rollout_cols_emit(model: kernels.RolloutModel, s0: torch.Tensor, Q: torch.Tensor,
                           pvec_b: torch.Tensor):
    """K1's session-row emit_terminal form: ``(cost [B, K], x_H [B, K, S])``
    of B sessions' rollouts in one launch; see the module docstring."""
    K = kernels.check_cols_shapes("cost_rollout_cols_emit", s0, Q, pvec_b)
    B = pvec_b.shape[0]
    if kernels.on_cpu(s0, Q, pvec_b):
        return cost_rollout_cols_emit_plain(model, s0, Q, pvec_b)
    x_term = torch.empty_like(s0)
    cost = _launch("cost_rollout_cols_emit", model, s0, Q, pvec_b, K, x_term)
    cost_rollout_cols_emit.launches += 1
    return cost.reshape(B, K), x_term.reshape(B, K, -1)


cost_rollout_cols_emit.launches = 0


# Each wrapper's kernel form (ops/kernels.py KERNEL_PLANTS).
FORMS = {"cost_rollout": "K1", "cost_rollout_emit": "K1's emit_terminal form",
         "cost_rollout_cols": "K1's session-row form",
         "cost_rollout_cols_emit": "K1's session-row emit_terminal form"}


def _launch(name: str, model: kernels.RolloutModel, s0, Q, pvec, ks: int,
            x_term=None) -> torch.Tensor:
    """Check the operands and launch K1 over sessions of ``ks`` rollouts,
    ``pvec``'s rows, or, with ``x_term [B*K, S]``, its emit_terminal form,
    which writes the terminal states there; returns the costs ``[B*K]``."""
    kernels.require(FORMS[name], model.plant)
    device = kernels.check_cuda_operands(name, s0=s0, Q=Q, pvec=pvec)
    K, S = s0.shape
    H, U = Q.shape[1], Q.shape[2]
    model.check_launch_shape(name, S, U, K, H, pvec.shape[-1])
    cost = torch.empty(K, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = kernels.load().ctt_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(),
            pvec.data_ptr(), cost.data_ptr(), None if x_term is None else x_term.data_ptr(),
            K, ks, H, *model.step_args(),
            model.max_cost, torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost
