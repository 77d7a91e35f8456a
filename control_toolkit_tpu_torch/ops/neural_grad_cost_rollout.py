"""K8: rollout cost under an MLP and its gradient — the counterpart of
control_toolkit_tpu/ops/pallas_grad.py:build_neural_grad_cost_rollout_kernel
(body ``_make_fwd_bwd_kernel``, runner ``_make_grad_runner``).

``neural_grad_cost_rollout(model, s0 [K,S], Q [K,H,U], pvec [N], net) ->
(cost [K], dQ [K,H,U])``: cost is K11's (ops/neural_rollout.py) and dQ its
gradient with respect to Q, so also the gradient of ``sum_k cost_k``.  It
is K7's structure (ops/grad_cost_rollout.py) with the network step in
place of the integrator: one forward sweep stores x_0..x_{H-1} and sums the
stage costs; one backward sweep from h = H-1 to 0 re-linearizes step h at
the stored x_h with ``adjoints.mlp_step_vjp`` and the cost's hand-written
adjoints:

    lam_H = d terminal / d x_H * 1/(H+1)
    dQ_h  = (du_net + gu) + gprev_{h+1}     gprev_H = 0
    lam_h = dx_net + gx

The weights get no gradient (the population optimizers descend in Q only).
The CUDA kernel is ``csrc/neural_grad_rollout.cu``;
``neural_grad_cost_rollout_plain`` is the same function in PyTorch.  The
wrapper runs the plain version only when every operand lies on the CPU;
for CUDA operands it launches the kernel or raises.

Its session-row (``slot_keys``, pallas_grad.py:401) form
``neural_grad_cost_rollout_cols`` (the batched-mpc gradient fleets') takes
B sessions' rollouts in one launch: ``s0 [B*K,S]`` and ``Q [B*K,H,U]``
session by session, each lane reading its rollout's session row of the
cost's ``pvec_b [B,N]``; the weights are shared.  It returns ``(cost
[B,K], dQ [B*K,H,U])``.

Its member-block (``n_members``, pallas_grad.py:402) form
``neural_grad_cost_rollout_ens`` (the PETS ensemble's gradient) takes a
stacked MLP of E members, rollout k under member k // (K/E), each block of
the launch staging its member's weights; its plain version is
``torch.autograd`` through K11's member-block plain version.

Its ``value_spec`` form (pallas_grad.py:119-141, :191-206) adds a learned
terminal value V, a tanh MLP ``value_ops = [w0, b0, ...]`` (the value
scale folded into its last layer: ``Optimizer._flatten_value_ops``), as
K7's does (ops/grad_cost_rollout.py):

    cost  = (acc + terminal(x_H) + V(x_H)) / (H+1)
    lam_H = ct * (d terminal / d x_H + dV / d x_H)

in each of the three: ``neural_grad_cost_rollout_value``, ``_cols_value``
(every session under the one V) and ``_ens_value`` (every member under
it, pallas_grad.py:158).  The kernel evaluates V and its VJP once a
rollout after the forward sweep (csrc/value_mlp.cuh); the plain versions
are ``plain_grad_loop(..., value_ops)`` and, for the member-block form,
``torch.autograd`` through K11's member-block emit_terminal plain version
plus V(x_H)/(H+1).  The net's tensors go in by pointer on every call, so
a re-fit rebuilds nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS, mlp_step_vjp, value_mlp_vjp
from control_toolkit_tpu_torch.ops.grad_cost_rollout import plain_grad_loop
from control_toolkit_tpu_torch.ops.neural_rollout import (
    check_shapes, ensemble_members, mlp_step, neural_cost_rollout_ens_emit_plain,
    neural_cost_rollout_ens_plain,
)


def neural_grad_cost_rollout_plain(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                   pvec: torch.Tensor, net: Dict, value_ops=None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch (pallas_grad.py:148-246); with
    ``value_ops``, its value_spec form's."""
    return plain_grad_loop(
        model, s0, Q, pvec, lambda x, u: mlp_step(net, x, u, model.predict_delta),
        lambda xs, us, lam: mlp_step_vjp(xs, us, net, model.predict_delta, lam), value_ops)


def _check_mlp(name: str, model: kernels.NetModel) -> None:
    if model.kind != "mlp" or model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"{name}: an MLP over a cost with adjoints, not a {model.kind} on "
                         f"{model.plant!r}")


def neural_grad_cost_rollout(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                             pvec: torch.Tensor, net: Dict
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rollout cost ``[K]`` and its gradient ``[K,H,U]`` under an MLP;
    see the module docstring."""
    check_shapes("neural_grad_cost_rollout", s0, Q, pvec)
    _check_mlp("neural_grad_cost_rollout", model)
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return neural_grad_cost_rollout_plain(model, s0, Q, pvec, net)
    cost, dQ = _launch("neural_grad_cost_rollout", model, s0, Q, pvec, net, s0.shape[0])
    neural_grad_cost_rollout.launches += 1
    return cost, dQ


neural_grad_cost_rollout.launches = 0


def neural_grad_cost_rollout_value(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                   pvec: torch.Tensor, net: Dict, value_ops
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's value_spec form: per-rollout cost ``[K]`` with the learned
    terminal value and its gradient ``[K,H,U]``; see the module docstring."""
    check_shapes("neural_grad_cost_rollout_value", s0, Q, pvec)
    _check_mlp("neural_grad_cost_rollout_value", model)
    if kernels.on_cpu(s0, Q, pvec, *net.values(), *value_ops):
        return neural_grad_cost_rollout_plain(model, s0, Q, pvec, net, value_ops)
    cost, dQ = _launch("neural_grad_cost_rollout_value", model, s0, Q, pvec, net, s0.shape[0],
                       value_ops=value_ops)
    neural_grad_cost_rollout_value.launches += 1
    return cost, dQ


neural_grad_cost_rollout_value.launches = 0


def neural_grad_cost_rollout_cols_plain(model: kernels.NetModel, s0: torch.Tensor,
                                        Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict,
                                        value_ops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's session-row form in PyTorch: K8's plain version over the B*K
    rollouts, each scored under its session's row of ``pvec_b``; ``(cost
    [B,K], dQ [B*K,H,U])``; with ``value_ops``, its value_spec form's."""
    B = pvec_b.shape[0]
    K = s0.shape[0] // B
    cost, dQ = neural_grad_cost_rollout_plain(model, s0, Q, kernels.session_rows(pvec_b, K).T,
                                              net, value_ops)
    return cost.reshape(B, K), dQ


def neural_grad_cost_rollout_cols(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                  pvec_b: torch.Tensor, net: Dict
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's session-row form: ``(cost [B,K], dQ [B*K,H,U])`` of B sessions'
    rollouts in one launch; see the module docstring."""
    K = kernels.check_cols_shapes("neural_grad_cost_rollout_cols", s0, Q, pvec_b)
    _check_mlp("neural_grad_cost_rollout_cols", model)
    if kernels.on_cpu(s0, Q, pvec_b, *net.values()):
        return neural_grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, net)
    cost, dQ = _launch("neural_grad_cost_rollout_cols", model, s0, Q, pvec_b, net, K)
    neural_grad_cost_rollout_cols.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


neural_grad_cost_rollout_cols.launches = 0


def neural_grad_cost_rollout_cols_value(model: kernels.NetModel, s0: torch.Tensor,
                                        Q: torch.Tensor, pvec_b: torch.Tensor, net: Dict,
                                        value_ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's session-row value_spec form: ``(cost [B,K], dQ [B*K,H,U])`` of B
    sessions' rollouts under one V in one launch; see the module
    docstring."""
    K = kernels.check_cols_shapes("neural_grad_cost_rollout_cols_value", s0, Q, pvec_b)
    _check_mlp("neural_grad_cost_rollout_cols_value", model)
    if kernels.on_cpu(s0, Q, pvec_b, *net.values(), *value_ops):
        return neural_grad_cost_rollout_cols_plain(model, s0, Q, pvec_b, net, value_ops)
    cost, dQ = _launch("neural_grad_cost_rollout_cols_value", model, s0, Q, pvec_b, net, K,
                       value_ops=value_ops)
    neural_grad_cost_rollout_cols_value.launches += 1
    return cost.reshape(pvec_b.shape[0], K), dQ


neural_grad_cost_rollout_cols_value.launches = 0


def neural_grad_cost_rollout_ens_plain(model: kernels.NetModel, s0: torch.Tensor,
                                       Q: torch.Tensor, pvec: torch.Tensor, net: Dict
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's member-block form in PyTorch: K11's member-block plain version
    and ``torch.autograd`` through it for dQ."""
    with torch.enable_grad():
        Qv = Q.detach().requires_grad_(True)
        cost = neural_cost_rollout_ens_plain(model, s0, Qv, pvec, net)
        (dQ,) = torch.autograd.grad(cost.sum(), Qv)
    return cost.detach(), dQ


def neural_grad_cost_rollout_ens(model: kernels.NetModel, s0: torch.Tensor, Q: torch.Tensor,
                                 pvec: torch.Tensor, net: Dict
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's member-block (``n_members``) form: ``(cost [K], dQ [K,H,U])``
    under a stacked MLP of E members, rollout k under member k // (K/E),
    in one launch; see the module docstring."""
    check_shapes("neural_grad_cost_rollout_ens", s0, Q, pvec)
    if model.kind != "mlp" or model.plant not in PLANT_ADJOINTS:
        raise ValueError(f"neural_grad_cost_rollout_ens: an MLP ensemble over a cost with "
                         f"adjoints, not a {model.kind} on {model.plant!r}")
    E = ensemble_members("neural_grad_cost_rollout_ens", net, s0.shape[0])
    if kernels.on_cpu(s0, Q, pvec, *net.values()):
        return neural_grad_cost_rollout_ens_plain(model, s0, Q, pvec, net)
    cost, dQ = _launch("neural_grad_cost_rollout_ens", model, s0, Q, pvec, net,
                       s0.shape[0] // E, members=E)
    neural_grad_cost_rollout_ens.launches += 1
    return cost, dQ


neural_grad_cost_rollout_ens.launches = 0


def neural_grad_cost_rollout_ens_value_plain(model: kernels.NetModel, s0: torch.Tensor,
                                             Q: torch.Tensor, pvec: torch.Tensor, net: Dict,
                                             value_ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """The member-block value_spec form in PyTorch: K11's member-block
    emit_terminal plain version plus V(x_H)/(H+1), and ``torch.autograd``
    through both for dQ."""
    H = Q.shape[1]
    with torch.enable_grad():
        Qv = Q.detach().requires_grad_(True)
        cost, x_term = neural_cost_rollout_ens_emit_plain(model, s0, Qv, pvec, net)
        cost = (cost * (H + 1) + value_mlp_vjp(value_ops, x_term, 1.0)[0]) / (H + 1)
        (dQ,) = torch.autograd.grad(cost.sum(), Qv)
    return cost.detach(), dQ


def neural_grad_cost_rollout_ens_value(model: kernels.NetModel, s0: torch.Tensor,
                                       Q: torch.Tensor, pvec: torch.Tensor, net: Dict, value_ops
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The value_spec form of K8's member-block form: ``(cost [K], dQ
    [K,H,U])`` under a stacked MLP of E members and one V; see the module
    docstring."""
    check_shapes("neural_grad_cost_rollout_ens_value", s0, Q, pvec)
    _check_mlp("neural_grad_cost_rollout_ens_value", model)
    E = ensemble_members("neural_grad_cost_rollout_ens_value", net, s0.shape[0])
    if kernels.on_cpu(s0, Q, pvec, *net.values(), *value_ops):
        return neural_grad_cost_rollout_ens_value_plain(model, s0, Q, pvec, net, value_ops)
    cost, dQ = _launch("neural_grad_cost_rollout_ens_value", model, s0, Q, pvec, net,
                       s0.shape[0] // E, members=E, value_ops=value_ops)
    neural_grad_cost_rollout_ens_value.launches += 1
    return cost, dQ


neural_grad_cost_rollout_ens_value.launches = 0


def _launch(name: str, model: kernels.NetModel, s0, Q, pvec, net: Dict, ks: int,
            members: int = 0, value_ops=None):
    """Check the operands and launch K8 over sessions of ``ks`` rollouts,
    ``pvec``'s rows, or (``members``) its member-block form over blocks of
    ``ks`` rollouts a member; with ``value_ops``, their value_spec forms.
    Returns ``(cost [B*K], dQ)``."""
    args, tensors = model.net_args(net, members=members)
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
        entry = "ctt_neural_grad_cost_rollout_ens" if members else "ctt_neural_grad_cost_rollout"
        rc = getattr(kernels.load(), entry)(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(),
            cost.data_ptr(), dQ.data_ptr(), xhist.data_ptr(), K, ks, H, model.max_cost,
            1.0 / (H + 1), args, value, torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, name)
    return cost, dQ
