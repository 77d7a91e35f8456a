"""Residual (``"ODE+res"``) kernel family: the cost kernel K12 and its
gradient twin K9 (counterpart of
control_toolkit_tpu/optimizers/kernel_families/residual.py).

The gates admit a ResidualPredictor over the cost its base plant's device
implementation evaluates (``ode.device_cost``), with ``force_scan`` off;
the gradient gate adds the plant's hand-written adjoints.  The base's
constants go in
the packed vector (``Optimizer._soa_bindings`` reads them from
``params["dyn"]["base"]``), the residual's tensors from
``params["dyn"]["res"]`` on every call, so an online-sysid install never
rebuilds.  The JAX gates' TPU conjuncts have no counterpart: K is masked
in the kernels.  K12's session-row form serves the batched-mpc fleet
(``MPPIOptimizer._make_batched_residual_step``, ``per_slot_dyn`` over the
base's constants), K9's and K12's its gradient fleets
(``batched_kernels``).  A learned value terminal rides K12's
``emit_terminal`` form, ``post(x_H)/(H+1)`` added outside it (JAX
``residual.py:100``), and, where V is a plain tanh MLP
(``_value_grad_spec``), K9's ``value_spec`` form; their session-row forms
serve a valued gradient fleet.  Any other post hook keeps
``torch.autograd`` for the gradient.
"""
from __future__ import annotations

from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (
    residual_grad_cost_rollout, residual_grad_cost_rollout_cols,
    residual_grad_cost_rollout_cols_value, residual_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.residual_rollout import (
    residual_cost_rollout, residual_cost_rollout_cols, residual_cost_rollout_cols_emit,
    residual_cost_rollout_emit,
)
from control_toolkit_tpu_torch.optimizers.kernel_families.ode import (
    device_cost, device_plant, value_hook_ok,
)

name = "residual"


def compatible_model(opt) -> bool:
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return isinstance(pred, ResidualPredictor) and device_cost(opt)


def can_use_cost(opt) -> bool:
    """K12's gate; a post-terminal hook is admitted (its emit_terminal
    form carries it)."""
    return not opt.force_scan and compatible_model(opt)


def residual_model(opt):
    """``(ResidualModel, pack)`` from the optimizer's SOA bindings (the
    base's constants, then the cost's)."""
    param_keys, pack, derivs, stage_soa, terminal_soa, pred = opt._soa_bindings()
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    model = kernels.ResidualModel(
        plant=device_plant(opt),
        param_keys=tuple(param_keys),
        derivs=derivs,
        stage=stage_soa,
        terminal=terminal_soa,
        integrator=pred.integrator,
        dt=pred.dt,
        intermediate_steps=pred.intermediate_steps,
        max_cost=float(cf.MAX_COST),
    )
    return model, pack


def build_cost(opt):
    """``cost_fn(s_tiled, Q, u_prev, params) -> [K]`` over K12; with a
    post-terminal hook, over its emit_terminal form, ``post(x_H)/(H+1)``
    added."""
    model, pack = residual_model(opt)
    post = opt._post_terminal_fn()
    kernels.require("K12" if post is None else "K12's emit_terminal form", model.plant)
    rollout = residual_cost_rollout if post is None else residual_cost_rollout_emit

    def raw_call(s_tiled, Q, u_prev, params):
        return rollout(model, s_tiled, Q, pack(params, u_prev), params["dyn"]["res"])

    return opt._finalize_cost_kernel(raw_call, post)


def can_use_grad(opt) -> bool:
    """K9's gate, with no post-terminal hook unless it is a plain tanh-MLP
    V, which K9's value_spec form differentiates."""
    return (not opt.force_scan and compatible_model(opt)
            and device_plant(opt) in PLANT_ADJOINTS and value_hook_ok(opt))


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K9; with a learned value terminal, over its value_spec form, the
    value net read from ``params`` at every call."""
    model, pack = residual_model(opt)
    kernels.require("K9's value_spec form" if opt._value_grad_spec() else "K9", model.plant)
    if opt._value_grad_spec():
        def grad_fn(s_tiled, Q, u_prev, params):
            return residual_grad_cost_rollout_value(model, s_tiled, Q, pack(params, u_prev),
                                                    params["dyn"]["res"],
                                                    opt._flatten_value_ops(params))
    else:
        def grad_fn(s_tiled, Q, u_prev, params):
            return residual_grad_cost_rollout(model, s_tiled, Q, pack(params, u_prev),
                                              params["dyn"]["res"])

    return grad_fn


def batched_kernels(opt):
    """The session-row forms for a B-session fleet over ``"ODE+res"`` (JAX
    ``residual.py:176``): ``(grad, cost, extra, param_keys)`` over K9's and
    K12's forms (with a learned value terminal, K9's session-row value_spec
    form and K12's session-row emit_terminal form), the base's constants in
    ``pvec_b`` (``per_slot_dyn`` among them) and the residual's weights
    read from ``dyn["res"]`` at every call (an online-sysid install
    rebuilds nothing)."""
    model, _ = residual_model(opt)
    valued = opt._value_grad_spec() is not None
    kernels.require("K9's session-row value_spec form" if valued else "K9's session-row form",
                    model.plant)
    kernels.require("K12's session-row emit_terminal form" if valued
                    else "K12's session-row form", model.plant)
    grad = residual_grad_cost_rollout_cols_value if valued else residual_grad_cost_rollout_cols
    cost = residual_cost_rollout_cols_emit if valued else residual_cost_rollout_cols
    return (lambda *a: grad(model, *a), lambda *a: cost(model, *a), lambda dyn: (dyn["res"],),
            model.param_keys)
