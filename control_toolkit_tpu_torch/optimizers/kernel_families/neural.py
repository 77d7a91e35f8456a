"""Learned-dynamics kernel family: the MLP cost kernel K11, the stacked
GRU/LSTM cost kernel K13 and the MLP gradient kernel K8 (counterpart of
control_toolkit_tpu/optimizers/kernel_families/neural.py).

The gates admit a float32 NeuralPredictor over a cost with a device
implementation (``DEVICE_COSTS``, the cost the plant evaluates),
``supports_fused_rollout``, scalar attributes, and ``force_scan`` off;
the gradient gate also refuses a recurrent net (its backward would need
the per-step hidden history).  The JAX gates'
TPU conjuncts (backend, tile divisibility, VMEM budgets) have no
counterpart: K is masked in the kernels and the wrappers raise on a net
whose weights exceed a block's shared memory.  The net's tensors, and a
recurrent net's live hidden, are read from ``params["dyn"]`` every call,
so a checkpoint swap or an advanced hidden needs no rebuild.  The
session-row forms of K11 and K13 serve the batched-mpc MPPI fleet
(``MPPIOptimizer._make_batched_neural_step`` and
``_make_batched_recurrent_step``), K8's and K11's its gradient fleets
(``batched_kernels``).  The ensemble's member-block (``n_members``) forms
are ``kernel_families/ensemble.py``'s.  A learned value terminal
(``costs/value_terminal.py``) rides K11's and K13's ``emit_terminal``
forms, ``post(x_H)/(H+1)`` added outside them
(``Optimizer._finalize_cost_kernel``), as JAX ``neural.py:121`` does, and,
where V is a plain tanh MLP (``_value_grad_spec``), K8's ``value_spec``
form, which evaluates V and seeds its backward with dV/dx_H (JAX
``neural.py:150-159``); its session-row form and K11's session-row
emit_terminal form serve a valued gradient fleet.  Any other post hook,
and a recurrent net's gradient, keep ``torch.autograd``, the JAX
package's XLA-AD.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.models.neural_predictor import NeuralPredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_value,
    neural_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    neural_cost_rollout, neural_cost_rollout_cols, neural_cost_rollout_cols_emit,
    neural_cost_rollout_emit, recurrent_cost_rollout, recurrent_cost_rollout_emit,
)
from control_toolkit_tpu_torch.optimizers.kernel_families.ode import (
    cost_plant, device_cost, value_hook_ok,
)

name = "neural"


def compatible_model(opt) -> bool:
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return (isinstance(pred, NeuralPredictor) and pred.compute_dtype == torch.float32
            and device_cost(opt))


def can_use_cost(opt) -> bool:
    """K11's (an MLP) or K13's (a GRU or LSTM) gate; a post-terminal hook
    is admitted (their emit_terminal forms carry it)."""
    return not opt.force_scan and compatible_model(opt)


def net_model(opt):
    """``(NetModel, pack)`` for the network-rollout kernels from the
    optimizer's SOA bindings without the dynamics constants."""
    param_keys, pack, _, stage_soa, terminal_soa, pred = opt._soa_bindings(include_dyn=False)
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    model = kernels.NetModel(
        plant=cost_plant(opt),
        param_keys=tuple(param_keys),
        stage=stage_soa,
        terminal=terminal_soa,
        kind=pred.arch["kind"],
        predict_delta=pred.predict_delta,
        max_cost=float(cf.MAX_COST),
    )
    return model, pack


def build_cost(opt):
    """``cost_fn(s_tiled, Q, u_prev, params) -> [K]`` over K11 (MLP) or K13
    (GRU/LSTM, from ``params["dyn"]["hidden"]``); with a post-terminal hook,
    over their emit_terminal forms, the hook's ``post(x_H)/(H+1)`` added
    (JAX ``neural.py:101``, ``:121``)."""
    model, pack = net_model(opt)
    post = opt._post_terminal_fn()
    kernels.require(("K11" if model.kind == "mlp" else "K13")
                    + ("" if post is None else "'s emit_terminal form"), model.plant)
    if model.kind == "mlp":
        rollout = neural_cost_rollout if post is None else neural_cost_rollout_emit

        def raw_call(s_tiled, Q, u_prev, params):
            return rollout(model, s_tiled, Q, pack(params, u_prev), params["dyn"]["net"])
    else:
        rollout = recurrent_cost_rollout if post is None else recurrent_cost_rollout_emit

        def raw_call(s_tiled, Q, u_prev, params):
            dyn = params["dyn"]
            return rollout(model, s_tiled, Q, pack(params, u_prev), dyn["net"], dyn["hidden"])
    return opt._finalize_cost_kernel(raw_call, post)


def can_use_grad(opt) -> bool:
    """K8's gate (an MLP), with no post-terminal hook unless it is a plain
    tanh-MLP V, which K8's value_spec form differentiates (JAX
    ``neural.py:150-159``)."""
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return (not opt.force_scan and compatible_model(opt) and not pred.recurrent
            and value_hook_ok(opt))


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K8; with a learned value terminal, over its value_spec form, the
    value net read from ``params`` at every call (a swap rebuilds
    nothing)."""
    model, pack = net_model(opt)
    kernels.require("K8's value_spec form" if opt._value_grad_spec() else "K8", model.plant)
    if opt._value_grad_spec():
        def grad_fn(s_tiled, Q, u_prev, params):
            return neural_grad_cost_rollout_value(model, s_tiled, Q, pack(params, u_prev),
                                                  params["dyn"]["net"],
                                                  opt._flatten_value_ops(params))
    else:
        def grad_fn(s_tiled, Q, u_prev, params):
            return neural_grad_cost_rollout(model, s_tiled, Q, pack(params, u_prev),
                                            params["dyn"]["net"])

    return grad_fn


def batched_kernels(opt):
    """The session-row forms for a B-session fleet over an MLP (JAX
    ``neural.py:218``): ``(grad, cost, extra, param_keys)`` over K8's and
    K11's forms (with a learned value terminal, K8's session-row value_spec
    form and K11's session-row emit_terminal form), the net's weights read
    from ``dyn["net"]`` at every call (shared by the sessions: a checkpoint
    swap rebuilds nothing)."""
    model, _ = net_model(opt)
    valued = opt._value_grad_spec() is not None
    kernels.require("K8's session-row value_spec form" if valued else "K8's session-row form",
                    model.plant)
    kernels.require("K11's session-row emit_terminal form" if valued
                    else "K11's session-row form", model.plant)
    grad = neural_grad_cost_rollout_cols_value if valued else neural_grad_cost_rollout_cols
    cost = neural_cost_rollout_cols_emit if valued else neural_cost_rollout_cols
    return (lambda *a: grad(model, *a), lambda *a: cost(model, *a), lambda dyn: (dyn["net"],),
            model.param_keys)
