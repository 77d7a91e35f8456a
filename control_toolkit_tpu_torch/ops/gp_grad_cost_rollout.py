"""K10: rollout cost under sparse-GP dynamics and its gradient — the
counterpart of
control_toolkit_tpu/ops/pallas_grad.py:build_gp_grad_cost_rollout_kernel.

``gp_grad_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N], ops) ->
(cost [K], dQ [K,H,U])``: cost is K14's (ops/gp_rollout.py) and dQ its
gradient with respect to Q, so also the gradient of ``sum_k cost_k``.  It
is K7's structure (ops/grad_cost_rollout.py) with the GP step: one forward
sweep stores x_0..x_{H-1} and sums the stage costs; one backward sweep
from h = H-1 to 0 re-linearizes step h at the stored x_h with
``adjoints.gp_step_vjp`` (the RBF block recomputed, then transposed) and
the cost's hand-written adjoints:

    lam_H = d terminal / d x_H * 1/(H+1)
    dQ_h  = (du_gp + gu) + gprev_{h+1}     gprev_H = 0
    lam_h = dx_gp + gx

The GP's tensors get no gradient.  The CUDA kernel is
``csrc/gp_rollout.cu``, each rollout's step split over the lanes of a
warp (``gp_grad_cost_rollout_lanes`` picks their number);
``gp_grad_cost_rollout_plain`` is the same function in PyTorch.  The
wrapper runs the plain version only when every operand lies on the CPU;
for CUDA operands it launches the kernel or raises.

Its session-row (``slot_keys``, pallas_grad.py:524) form
``gp_grad_cost_rollout_cols`` (the batched-mpc gradient fleets') takes B
sessions' rollouts in one launch: ``s0 [B*K,S]`` and ``Q [B*K,H,U]``
session by session, every lane of rollout b*K + k reading row b of the
cost's ``pvec_b [B,N]``; the GP's operands are shared.  It returns
``(cost [B,K], dQ [B*K,H,U])``.

Their ``value_spec`` forms ``gp_grad_cost_rollout_value`` and
``gp_grad_cost_rollout_cols_value`` (pallas_grad.py:119-141, :191-206)
add a learned terminal value V, a tanh MLP ``value_ops = [w0, b0, ...]``
with the value scale folded into its last layer, as K7's and K8's do: V
joins the terminal cost and ``ct * dV/dx_H`` seeds the backward sweep,
every session under the one V; the kernel evaluates V on one lane of each
rollout and shuffles it to the others, at its own lanes a rollout.  Their
plain versions are the plain versions above with ``value_ops``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import ctypes

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS, gp_step_vjp
from control_toolkit_tpu_torch.ops.gp_rollout import gp_step
from control_toolkit_tpu_torch.ops.grad_cost_rollout import plain_grad_loop
from control_toolkit_tpu_torch.ops.neural_rollout import check_shapes


def gp_grad_cost_rollout_plain(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec: torch.Tensor, ops: Dict[str, torch.Tensor], value_ops=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch (pallas_grad.py:169-246 over the
    GP step of :547-559); with ``value_ops``, its value_spec form's."""
    return plain_grad_loop(model, s0, Q, pvec, lambda x, u: gp_step(ops, x, u),
                           lambda xs, us, lam: gp_step_vjp(xs, us, ops, lam), value_ops)


def gp_grad_cost_rollout(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                         pvec: torch.Tensor, ops: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: per-rollout cost ``[K]`` and its gradient ``[K,H,U]`` under the
    GP; see the module docstring."""
    return gp_grad_cost_rollout_lanes(model, s0, Q, pvec, ops, 0)


def gp_grad_cost_rollout_lanes(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec: torch.Tensor, ops: Dict[str, torch.Tensor], lanes: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 with ``lanes`` lanes a rollout (4, 8, 16 or 32; 0 for the
    kernel's own, which ``gp_grad_cost_rollout`` takes): the split's
    measurement (chip_smoke.py phase 21).  Counted as K10's launches."""
    check_shapes("gp_grad_cost_rollout", s0, Q, pvec)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"gp_grad_cost_rollout: no cost adjoints for the {model.plant!r} plant")
    if lanes not in (0, 4, 8, 16, 32):
        raise ValueError(f"gp_grad_cost_rollout: {lanes} lanes a rollout (4, 8, 16 or 32; 0: "
                         "the kernel's)")
    if kernels.on_cpu(s0, Q, pvec, *ops.values()):
        return gp_grad_cost_rollout_plain(model, s0, Q, pvec, ops)
    cost, dQ = _launch("gp_grad_cost_rollout", model, s0, Q, pvec, ops, s0.shape[0], lanes)
    gp_grad_cost_rollout.launches += 1
    return cost, dQ


gp_grad_cost_rollout.launches = 0


def gp_grad_cost_rollout_value(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                               pvec: torch.Tensor, ops: Dict[str, torch.Tensor], value_ops
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's value_spec form: per-rollout cost ``[K]`` with the learned
    terminal value and its gradient ``[K,H,U]``; see the module docstring."""
    check_shapes("gp_grad_cost_rollout_value", s0, Q, pvec)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"gp_grad_cost_rollout_value: no cost adjoints for the "
                         f"{model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec, *ops.values(), *value_ops):
        return gp_grad_cost_rollout_plain(model, s0, Q, pvec, ops, value_ops)
    cost, dQ = _launch("gp_grad_cost_rollout_value", model, s0, Q, pvec, ops, s0.shape[0], 0,
                       value_ops)
    gp_grad_cost_rollout_value.launches += 1
    return cost, dQ


gp_grad_cost_rollout_value.launches = 0


def gp_grad_cost_rollout_cols_plain(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                                    pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor],
                                    value_ops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's session-row form in PyTorch: K10's plain version over the B*K
    rollouts, each scored under its session's row of ``pvec_b``; ``(cost
    [B,K], dQ [B*K,H,U])``; with ``value_ops``, its value_spec form's."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, dQ = gp_grad_cost_rollout_plain(model, s0, Q, kernels.session_rows(pvec_b, K).T, ops,
                                          value_ops)
    return cost.reshape(B, K), dQ


def gp_grad_cost_rollout_cols(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                              pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's session-row form: ``(cost [B,K], dQ [B*K,H,U])`` of B
    sessions' rollouts in one launch; see the module docstring."""
    K = kernels.check_cols_shapes("gp_grad_cost_rollout_cols", s0, Q, pvec_b)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"gp_grad_cost_rollout_cols: no cost adjoints for the "
                         f"{model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec_b, *ops.values()):
        return gp_grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, ops)
    cost, dQ = _launch("gp_grad_cost_rollout_cols", model, s0, Q, pvec_b, ops, K, 0)
    gp_grad_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


gp_grad_cost_rollout_cols.launches = 0


def gp_grad_cost_rollout_cols_value(model: kernels.GPModel, s0: torch.Tensor, Q: torch.Tensor,
                                    pvec_b: torch.Tensor, ops: Dict[str, torch.Tensor],
                                    value_ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's session-row value_spec form: ``(cost [B,K], dQ [B*K,H,U])`` of
    B sessions' rollouts under one V in one launch; see the module
    docstring."""
    K = kernels.check_cols_shapes("gp_grad_cost_rollout_cols_value", s0, Q, pvec_b)
    if model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"gp_grad_cost_rollout_cols_value: no cost adjoints for the "
                         f"{model.plant!r} plant")
    if kernels.on_cpu(s0, Q, pvec_b, *ops.values(), *value_ops):
        return gp_grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, ops, value_ops)
    cost, dQ = _launch("gp_grad_cost_rollout_cols_value", model, s0, Q, pvec_b, ops, K, 0,
                       value_ops)
    gp_grad_cost_rollout_cols_value.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


gp_grad_cost_rollout_cols_value.launches = 0


def _launch(name: str, model: kernels.GPModel, s0, Q, pvec, ops: Dict[str, torch.Tensor],
            ks: int, lanes: int, value_ops=None):
    """Check the operands and launch K10 with ``lanes`` lanes a rollout over
    sessions of ``ks`` rollouts, ``pvec``'s rows (with ``value_ops``, its
    value_spec form); returns ``(cost [B*K], dQ)``."""
    args, tensors = model.gp_args(ops)
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
        rc = kernels.load().ctt_gp_grad_cost_rollout(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), dQ.data_ptr(), xhist.data_ptr(), K, ks, H, model.max_cost,
            1.0 / (H + 1), lanes, args, value, torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, f"{name} (M={args.M} inducing points)")
    return cost, dQ
