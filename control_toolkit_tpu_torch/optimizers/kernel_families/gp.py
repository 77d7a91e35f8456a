"""Sparse-GP kernel family: the cost kernel K14 and its gradient twin K10
(counterpart of control_toolkit_tpu/optimizers/kernel_families/gp.py).

The gates admit a GPPredictor over the cost its environment's device plant
evaluates (``ode.device_cost``), with ``force_scan`` off.  The GP's
tensors are read from ``params["dyn"]["gp"]`` on every call and
precomputed (``flatten_gp_weights``) once per posterior: again only when
that subtree is another object, as ``MPCController._assemble_params``
places a re-fit's.  So a re-fit posterior never rebuilds.  The JAX gates' TPU conjuncts (VMEM tile budgets) have no
counterpart: K is masked in the kernels, and the wrappers raise on a GP
whose inducing points exceed a block's shared memory.  K14's session-row
form serves the batched-mpc MPPI fleet
(``MPPIOptimizer._make_batched_gp_step``, over ``cached_operands``), K10's
and K14's its gradient fleets (``batched_kernels``).  A learned value
terminal rides K14's ``emit_terminal`` form, ``post(x_H)/(H+1)`` added
outside it (JAX ``gp.py:87``), and, where V is a plain tanh MLP
(``_value_grad_spec``), K10's ``value_spec`` form; their session-row forms
serve a valued gradient fleet.  Any other post hook keeps
``torch.autograd`` for the gradient.
"""
from __future__ import annotations

from control_toolkit_tpu_torch.models.gp_predictor import GPPredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import (
    gp_grad_cost_rollout, gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_value,
    gp_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.gp_rollout import (
    flatten_gp_weights, gp_cost_rollout, gp_cost_rollout_cols, gp_cost_rollout_cols_emit,
    gp_cost_rollout_emit,
)
from control_toolkit_tpu_torch.optimizers.kernel_families.ode import (
    cost_plant, device_cost, value_hook_ok,
)

name = "gp"


def compatible_model(opt) -> bool:
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return isinstance(pred, GPPredictor) and device_cost(opt)


def can_use_cost(opt) -> bool:
    """K14's gate; a post-terminal hook is admitted (its emit_terminal
    form carries it)."""
    return not opt.force_scan and compatible_model(opt)


def gp_model(opt):
    """``(GPModel, pack)`` from the optimizer's SOA bindings without the
    dynamics constants."""
    param_keys, pack, _, stage_soa, terminal_soa, _ = opt._soa_bindings(include_dyn=False)
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    model = kernels.GPModel(plant=cost_plant(opt), param_keys=tuple(param_keys),
                            stage=stage_soa, terminal=terminal_soa, max_cost=float(cf.MAX_COST))
    return model, pack


def cached_operands():
    """``operands(gp) -> flatten_gp_weights(gp)``, recomputed only when
    ``gp`` is not the object of the last call."""
    last = [None, None]

    def operands(gp_tree):
        if last[0] is not gp_tree:
            last[:] = [gp_tree, flatten_gp_weights(gp_tree)]
        return last[1]

    return operands


def build_cost(opt):
    """``cost_fn(s_tiled, Q, u_prev, params) -> [K]`` over K14; with a
    post-terminal hook, over its emit_terminal form, ``post(x_H)/(H+1)``
    added."""
    model, pack = gp_model(opt)
    operands = cached_operands()
    post = opt._post_terminal_fn()
    kernels.require("K14" if post is None else "K14's emit_terminal form", model.plant)
    rollout = gp_cost_rollout if post is None else gp_cost_rollout_emit

    def raw_call(s_tiled, Q, u_prev, params):
        return rollout(model, s_tiled, Q, pack(params, u_prev), operands(params["dyn"]["gp"]))

    return opt._finalize_cost_kernel(raw_call, post)


def can_use_grad(opt) -> bool:
    """K10's gate, with no post-terminal hook unless it is a plain tanh-MLP
    V, which K10's value_spec form differentiates."""
    return not opt.force_scan and compatible_model(opt) and value_hook_ok(opt)


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K10; with a learned value terminal, over its value_spec form, the
    value net read from ``params`` at every call."""
    model, pack = gp_model(opt)
    operands = cached_operands()
    kernels.require("K10's value_spec form" if opt._value_grad_spec() else "K10", model.plant)
    if opt._value_grad_spec():
        def grad_fn(s_tiled, Q, u_prev, params):
            return gp_grad_cost_rollout_value(model, s_tiled, Q, pack(params, u_prev),
                                              operands(params["dyn"]["gp"]),
                                              opt._flatten_value_ops(params))
    else:
        def grad_fn(s_tiled, Q, u_prev, params):
            return gp_grad_cost_rollout(model, s_tiled, Q, pack(params, u_prev),
                                        operands(params["dyn"]["gp"]))

    return grad_fn


def batched_kernels(opt):
    """The session-row forms for a B-session fleet over the GP (JAX
    ``gp.py:174``): ``(grad, cost, extra, param_keys)`` over K10's and
    K14's forms (with a learned value terminal, K10's session-row
    value_spec form and K14's session-row emit_terminal form), the GP's
    operands flattened from ``dyn["gp"]`` once a posterior
    (``cached_operands``: a hot-swap rebuilds nothing)."""
    model, _ = gp_model(opt)
    operands = cached_operands()
    valued = opt._value_grad_spec() is not None
    kernels.require("K10's session-row value_spec form" if valued else "K10's session-row form",
                    model.plant)
    kernels.require("K14's session-row emit_terminal form" if valued
                    else "K14's session-row form", model.plant)
    grad = gp_grad_cost_rollout_cols_value if valued else gp_grad_cost_rollout_cols
    cost = gp_cost_rollout_cols_emit if valued else gp_cost_rollout_cols
    return (lambda *a: grad(model, *a), lambda *a: cost(model, *a),
            lambda dyn: (operands(dyn["gp"]),), model.param_keys)
