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
(``Optimizer._finalize_cost_kernel``), as JAX ``neural.py:121`` does.
Not ported: K8's ``value_spec`` form: over a cost with a post-terminal
hook the gradient gate raises NotImplementedError naming it (a recurrent
net's gradient keeps ``torch.autograd``, the JAX package's XLA-AD).
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.models.neural_predictor import NeuralPredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    neural_cost_rollout, neural_cost_rollout_cols, neural_cost_rollout_emit,
    recurrent_cost_rollout, recurrent_cost_rollout_emit,
)
from control_toolkit_tpu_torch.optimizers.kernel_families.ode import device_cost, refuse_value

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
        plant=pred.environment_name,
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
    """K8's gate (an MLP); raises for a cost with a post-terminal hook
    (its value_spec form is not ported)."""
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    ok = not opt.force_scan and compatible_model(opt) and not pred.recurrent
    if ok:
        refuse_value(opt, "K8's value_spec form")
    return ok


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K8."""
    model, pack = net_model(opt)

    def grad_fn(s_tiled, Q, u_prev, params):
        return neural_grad_cost_rollout(model, s_tiled, Q, pack(params, u_prev),
                                        params["dyn"]["net"])

    return grad_fn


def batched_kernels(opt):
    """The session-row forms for a B-session fleet over an MLP (JAX
    ``neural.py:218``): ``(grad, cost, extra, param_keys)`` over K8's and
    K11's forms, the net's weights read from ``dyn["net"]`` at every call
    (shared by the sessions: a checkpoint swap rebuilds nothing)."""
    model, _ = net_model(opt)
    return (lambda *a: neural_grad_cost_rollout_cols(model, *a),
            lambda *a: neural_cost_rollout_cols(model, *a), lambda dyn: (dyn["net"],),
            model.param_keys)
