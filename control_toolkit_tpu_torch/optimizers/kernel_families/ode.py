"""Analytic ODE kernel family: the cost kernel K1 and its gradient twin K7
(counterpart of control_toolkit_tpu/optimizers/kernel_families/ode.py).

The cost gate admits an ODE predictor whose plant has a device
implementation (``ops/kernels.py`` PLANT_IDS, with the cost that plant
evaluates), a cost with ``supports_fused_rollout`` and scalar attributes,
and ``force_scan`` off; the gradient gate adds a plant with hand-written
adjoints (``ops/adjoints.py`` PLANT_ADJOINTS).  The JAX gates' TPU
conjuncts (backend, ``K % tile``, ``grad_tile_for``, VMEM budgets) have no
counterpart: K is masked in the kernels, and on CPU tensors the kernel
wrappers run their plain versions.  The session-row (``slot_keys``) forms
of K7 and K1 serve the batched-mpc gradient fleets (``batched_kernels``,
bound by ``kernel_families/batched.py``) and K1's the modular batched CEM
step.  Not ported: the gradient kernel's ``value_spec`` (an in-kernel
learned value terminal); ``compatible_model`` refuses a
``post_terminal_cost``, so it is not reachable.
"""
from __future__ import annotations

import numpy as np

from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from control_toolkit_tpu_torch.models.predictors import ODEPredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_cols
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_cols,
)

name = "ode"

# Environment -> the cost class whose terms its device plant evaluates.
DEVICE_COSTS = {"cartpole": CartpoleQuadraticCost}


def device_cost(opt) -> bool:
    """The optimizer's cost is the one its environment's device plant
    evaluates, fusable, with no post-terminal hook and scalar attributes:
    the cost half of every kernel family's gate."""
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return (
        pred.environment_name in DEVICE_COSTS
        and type(cf) is DEVICE_COSTS[pred.environment_name]
        and cf.supports_fused_rollout
        and cf.post_terminal_cost is None
        and all(np.ndim(v) == 0 for v in cf.attr_defaults.values())
    )


def compatible_model(opt) -> bool:
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return isinstance(pred, ODEPredictor) and device_cost(opt)


def can_use_cost(opt) -> bool:
    return not opt.force_scan and compatible_model(opt)


def rollout_model(opt):
    """``(RolloutModel, pack)`` for the rollout kernels from the
    optimizer's SOA bindings."""
    param_keys, pack, derivs, stage_soa, terminal_soa, pred = opt._soa_bindings()
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    model = kernels.RolloutModel(
        plant=pred.environment_name,
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
    """``cost_fn(s_tiled, Q, u_prev, params) -> [K]`` over K1, with the
    semantics of ``Optimizer._fused_cost``; the scalar parameters are
    packed per call, so weight and attribute changes need no rebuild."""
    model, pack = rollout_model(opt)

    def cost_fn(s_tiled, Q, u_prev, params):
        return cost_rollout(model, s_tiled, Q, pack(params, u_prev))

    return cost_fn


def can_use_grad(opt) -> bool:
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return can_use_cost(opt) and pred.environment_name in PLANT_ADJOINTS


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K7, with d(sum_k cost_k)/dQ semantics; the same per-call
    parameter packing as ``build_cost``."""
    model, pack = rollout_model(opt)

    def grad_fn(s_tiled, Q, u_prev, params):
        return grad_cost_rollout(model, s_tiled, Q, pack(params, u_prev))

    return grad_fn


def batched_kernels(opt):
    """The session-row forms for a B-session fleet (JAX ``ode.py:167``):
    ``(grad, cost, extra, param_keys)`` with ``grad(s0 [B*K,S], Q
    [B*K,H,U], pvec_b [B,N], *extra(dyn)) -> (cost [B,K], dQ)`` over K7's
    form, ``cost(...) -> [B,K]`` over K1's, no extra operands (the
    dynamics constants ride in ``pvec_b``) and the packed layout."""
    model, _ = rollout_model(opt)
    return (lambda *a: grad_cost_rollout_cols(model, *a),
            lambda *a: cost_rollout_cols(model, *a), lambda dyn: (), model.param_keys)
