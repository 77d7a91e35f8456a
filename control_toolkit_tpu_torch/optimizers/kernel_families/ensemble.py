"""PETS ensemble kernel family: the member-block (``n_members``) forms of
K11 and K8 (counterpart of
control_toolkit_tpu/optimizers/kernel_families/ensemble.py).

A TS-inf ensemble of E MLPs over K rollouts, block e of K/E rollouts under
member e, in one launch: each block of the launch stages its member's
weights, so an E-member rollout costs one net's operations.  The gates
admit a TS-inf, non-probabilistic ``EnsemblePredictor`` over a cost with a
device implementation (``ode.device_cost``: ``supports_fused_rollout``,
scalar attributes) and ``force_scan`` off.  A learned value terminal
rides the cost form's ``emit_terminal`` form, ``post(x_H)/(H+1)`` added
outside it (JAX ``ensemble.py:102``), under ``risk_weight`` too, and,
where V is a plain tanh MLP (``_value_grad_spec``), the value_spec form of
K8's member-block form, every member under the one V (JAX
``ensemble.py:139-147``); any other post hook keeps ``torch.autograd``.
The gradient gate also refuses ``risk_weight`` and ``robust_eval``, with V
or without (the kernel's dQ has no disagreement penalty and scores each
plan under one member; those objectives keep ``torch.autograd`` through
the loop).  The
JAX gates' TPU conjuncts (backend, ``ensemble_tile_for``, ``grad_tile``)
have no counterpart: a ragged K/E is masked in the kernels, and the
wrappers raise on a member net whose weights exceed a block's shared
memory or on K % E != 0 (``configure`` refuses that first).  The stacked
weights are read from ``params["dyn"]["net"]`` at every call, so a re-fit
or a checkpoint swap rebuilds nothing.  No batched (session-row) form:
the JAX package keeps a fleet of ensembles on the vmapped per-slot step,
which the port refuses (``controllers/batched_mpc.py:_refusal``).
"""
from __future__ import annotations

from control_toolkit_tpu_torch.models.ensemble_predictor import EnsemblePredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout_ens, neural_grad_cost_rollout_ens_value,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    neural_cost_rollout_ens, neural_cost_rollout_ens_emit,
)
from control_toolkit_tpu_torch.optimizers.kernel_families.ode import (
    cost_plant, device_cost, value_hook_ok,
)

name = "ensemble"


def compatible_model(opt) -> bool:
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return (isinstance(pred, EnsemblePredictor) and pred.ts == "inf"
            and not pred.probabilistic and device_cost(opt))


def can_use_cost(opt) -> bool:
    """The gate of K11's member-block form; a post-terminal hook is
    admitted (its emit_terminal form carries it)."""
    return not opt.force_scan and compatible_model(opt)


def net_model(opt):
    """``(NetModel, pack)`` for the member-block forms from the optimizer's
    SOA bindings without dynamics constants."""
    param_keys, pack, _, stage_soa, terminal_soa, pred = opt._soa_bindings(include_dyn=False)
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    model = kernels.NetModel(
        plant=cost_plant(opt),
        param_keys=tuple(param_keys),
        stage=stage_soa,
        terminal=terminal_soa,
        kind="mlp",
        predict_delta=pred.predict_delta,
        max_cost=float(cf.MAX_COST),
    )
    return model, pack


def build_cost(opt):
    """``cost_fn(s_tiled, Q, u_prev, params) -> [K]`` over K11's member-block
    form; with a post-terminal hook, over its emit_terminal form,
    ``post(x_H)/(H+1)`` added."""
    model, pack = net_model(opt)
    post = opt._post_terminal_fn()
    kernels.require("K11's member-block form" if post is None
                    else "K11's member-block emit_terminal form", model.plant)
    rollout = neural_cost_rollout_ens if post is None else neural_cost_rollout_ens_emit

    def raw_call(s_tiled, Q, u_prev, params):
        return rollout(model, s_tiled, Q, pack(params, u_prev), params["dyn"]["net"])

    return opt._finalize_cost_kernel(raw_call, post)


def can_use_grad(opt) -> bool:
    """The gate of K8's member-block form, with no post-terminal hook
    unless it is a plain tanh-MLP V (its value_spec form)."""
    return (not opt.force_scan and compatible_model(opt) and not opt.risk_weight
            and not opt.robust_eval and value_hook_ok(opt))


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K8's member-block form; with a learned value terminal, over its
    value_spec form, the value net read from ``params`` at every call."""
    model, pack = net_model(opt)
    kernels.require("K8's member-block value_spec form" if opt._value_grad_spec()
                    else "K8's member-block form", model.plant)
    if opt._value_grad_spec():
        def grad_fn(s_tiled, Q, u_prev, params):
            return neural_grad_cost_rollout_ens_value(model, s_tiled, Q, pack(params, u_prev),
                                                      params["dyn"]["net"],
                                                      opt._flatten_value_ops(params))
    else:
        def grad_fn(s_tiled, Q, u_prev, params):
            return neural_grad_cost_rollout_ens(model, s_tiled, Q, pack(params, u_prev),
                                                params["dyn"]["net"])

    return grad_fn
