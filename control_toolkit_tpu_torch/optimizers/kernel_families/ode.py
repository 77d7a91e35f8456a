"""Analytic ODE kernel family: the cost kernel K1 and its gradient twin K7
(counterpart of control_toolkit_tpu/optimizers/kernel_families/ode.py).

The cost gate admits an ODE predictor and a cost that its environment's
device plants evaluate (``DEVICE_COSTS``: a plant is a (dynamics, cost)
pair, ``ops/kernels.py`` PLANT_IDS; ``plant_key`` gives a ``:fast``
predictor its plant's fast plant, the polynomial-trig instance of every
kernel, whose fully-fused forms draw the fast normals), with
``supports_fused_rollout`` and scalar attributes, and ``force_scan`` off;
the gradient gate adds a plant with hand-written adjoints
(``ops/adjoints.py`` PLANT_ADJOINTS).  Every form of K1 and K7 carries
every plant (``ops/kernels.py`` KERNEL_PLANTS); a kernel that the gate
admits but that has no instance of the plant would raise where it is bound
(``kernels.require``), as does every other
family's: a (dynamics, cost) pair that the JAX package would send to a
kernel never takes the scan here instead.  A cost that is no device
plant's (a user's subclass, an array-attribute cost such as
pointmass/trajectory) takes the scan in both packages.  The JAX gates' TPU
conjuncts (backend, ``K % tile``, ``grad_tile_for``, VMEM budgets) have no
counterpart: K is masked in the kernels, and on CPU tensors the kernel
wrappers run their plain versions.  The session-row (``slot_keys``) forms
of K7 and K1 serve the batched-mpc gradient fleets (``batched_kernels``,
bound by ``kernel_families/batched.py``) and K1's the modular batched CEM
step.

A learned value terminal (``costs/value_terminal.py``; the type check
reads a ValueTerminalCost's base) rides the cost kernel's
``emit_terminal`` form, ``post(x_H)/(H+1)`` added outside it
(``Optimizer._finalize_cost_kernel``), and, for a plain tanh MLP V,
K7's ``value_spec`` form; any other post hook takes ``torch.autograd``
through the fused loop for its gradient, as the JAX package takes XLA-AD.
A valued gradient fleet runs K7's session-row value_spec form and K1's
session-row emit_terminal form (``batched_kernels``).  The other
families' gates call ``device_cost`` and ``value_hook_ok`` too: their
cost kernels' emit_terminal forms carry the hook, their gradient kernels'
value_spec forms V, so no kernel drops it.
"""
from __future__ import annotations

import numpy as np

from control_toolkit_tpu_torch.costs.acrobot import AcrobotSwingupCost
from control_toolkit_tpu_torch.costs.arm2 import Arm2ReachCost
from control_toolkit_tpu_torch.costs.car import CarObstacleCost, CarWaypointCost
from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from control_toolkit_tpu_torch.costs.pendulum import PendulumQuadraticCost
from control_toolkit_tpu_torch.costs.pointmass import PointMassObstacleCost, PointMassQuadraticCost
from control_toolkit_tpu_torch.costs.quadrotor2d import Quadrotor2DWaypointCost
from control_toolkit_tpu_torch.costs.quadrotor3d import Quadrotor3DWaypointCost
from control_toolkit_tpu_torch.models.predictors import ODEPredictor
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.adjoints import PLANT_ADJOINTS
from control_toolkit_tpu_torch.costs.value_terminal import ValueTerminalCost
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout, cost_rollout_cols, cost_rollout_cols_emit, cost_rollout_emit,
)
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_cols, grad_cost_rollout_cols_value,
    grad_cost_rollout_value,
)

name = "ode"

# Environment -> {cost class: the device plant that evaluates its terms
# over the environment's dynamics}; the lookup is by exact type, so
# CarObstacleCost, a CarWaypointCost subclass, finds its own plant.
DEVICE_COSTS = {
    "cartpole": {CartpoleQuadraticCost: "cartpole"},
    "pendulum": {PendulumQuadraticCost: "pendulum"},
    "acrobot": {AcrobotSwingupCost: "acrobot"},
    "pointmass": {PointMassQuadraticCost: "pointmass",
                  PointMassObstacleCost: "pointmass_obstacles"},
    "quadrotor2d": {Quadrotor2DWaypointCost: "quadrotor2d"},
    "quadrotor3d": {Quadrotor3DWaypointCost: "quadrotor3d"},
    "car": {CarWaypointCost: "car", CarObstacleCost: "car_obstacles"},
    "arm2": {Arm2ReachCost: "arm2"},
}


def cost_plant(opt):
    """The device plant of the optimizer's cost (a ValueTerminalCost's
    base) over its environment's dynamics when the cost is fusable with
    scalar attributes (the cost half of every kernel family's gate), else
    None: such a cost takes the scan."""
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    base = cf.base if isinstance(cf, ValueTerminalCost) else cf
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    plant = DEVICE_COSTS.get(pred.environment_name, {}).get(type(base))
    if (plant is None or not cf.supports_fused_rollout
            or not all(np.ndim(v) == 0 for v in cf.attr_defaults.values())):
        return None
    return plant


def device_cost(opt) -> bool:
    """The optimizer's cost is one that its environment's device plants
    evaluate (``cost_plant``).  A post-terminal hook is admitted: the cost
    kernels' emit_terminal forms carry it; the gradient gates add
    ``value_hook_ok``."""
    return cost_plant(opt) is not None


def device_plant(opt) -> str:
    """The (dynamics, cost) plant of an ODE or residual predictor's
    rollouts (``kernels.plant_key``)."""
    pred = getattr(opt.predictor, "predictor", opt.predictor)
    return kernels.plant_key(pred, cost_plant(opt))


def value_hook_ok(opt) -> bool:
    """The post-terminal half of every gradient gate: no hook, or a plain
    tanh-MLP V (``_value_grad_spec``), which the gradient kernels' value_spec
    forms differentiate; any other hook keeps torch.autograd, where a
    kernel would drop its dQ (JAX ``ode.py:106-117``)."""
    return opt._post_terminal_fn() is None or opt._value_grad_spec() is not None


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
    plant = device_plant(opt)
    model = kernels.RolloutModel(
        plant=plant,
        param_keys=tuple(param_keys),
        derivs=derivs,
        stage=stage_soa,
        terminal=terminal_soa,
        integrator=pred.integrator,
        dt=pred.dt,
        intermediate_steps=pred.intermediate_steps,
        max_cost=float(cf.MAX_COST),
        fast_sampling=plant in kernels.EXACT_IS_FAST and bool(getattr(pred, "fast_math", False)),
    )
    return model, pack


def build_cost(opt):
    """``cost_fn(s_tiled, Q, u_prev, params) -> [K]`` over K1, with the
    semantics of ``Optimizer._fused_cost``; the scalar parameters are
    packed per call, so weight and attribute changes need no rebuild.
    With a post-terminal hook, over K1's emit_terminal form, the hook's
    ``post(x_H)/(H+1)`` added (JAX ``ode.py:81-92``)."""
    model, pack = rollout_model(opt)
    post = opt._post_terminal_fn()
    kernels.require("K1" if post is None else "K1's emit_terminal form", model.plant)
    if post is None:
        def cost_fn(s_tiled, Q, u_prev, params):
            return cost_rollout(model, s_tiled, Q, pack(params, u_prev))

        return cost_fn

    def raw_call(s_tiled, Q, u_prev, params):
        return cost_rollout_emit(model, s_tiled, Q, pack(params, u_prev))

    return opt._finalize_cost_kernel(raw_call, post)


def can_use_grad(opt) -> bool:
    """K7's gate: K1's, a plant with adjoints, and no post-terminal hook
    unless it is a plain tanh-MLP V (``_value_grad_spec``), which K7's
    value_spec form differentiates; any other hook keeps torch.autograd,
    where the kernel would drop its dQ (JAX ``ode.py:106-117``)."""
    return can_use_cost(opt) and device_plant(opt) in PLANT_ADJOINTS and value_hook_ok(opt)


def build_grad(opt):
    """``grad_fn(s_tiled, Q, u_prev, params) -> (cost [K], dQ [K,H,U])``
    over K7, with d(sum_k cost_k)/dQ semantics; the same per-call
    parameter packing as ``build_cost``.  With a learned value terminal,
    over K7's value_spec form, the net's tensors (the scale folded into
    its last layer, ``_flatten_value_ops``) passed on every call."""
    model, pack = rollout_model(opt)
    kernels.require("K7's value_spec form" if opt._value_grad_spec() else "K7", model.plant)
    if opt._value_grad_spec():
        def grad_fn(s_tiled, Q, u_prev, params):
            return grad_cost_rollout_value(model, s_tiled, Q, pack(params, u_prev),
                                           opt._flatten_value_ops(params))
    else:
        def grad_fn(s_tiled, Q, u_prev, params):
            return grad_cost_rollout(model, s_tiled, Q, pack(params, u_prev))

    return grad_fn


def batched_kernels(opt):
    """The session-row forms for a B-session fleet (JAX ``ode.py:167``):
    ``(grad, cost, extra, param_keys)`` with ``grad(s0 [B*K,S], Q
    [B*K,H,U], pvec_b [B,N], *extra(dyn)) -> (cost [B,K], dQ)`` over K7's
    form, ``cost(...) -> [B,K]`` over K1's, no extra operands (the
    dynamics constants ride in ``pvec_b``) and the packed layout; with a
    learned value terminal, K7's session-row value_spec form and K1's
    session-row emit_terminal form."""
    model, _ = rollout_model(opt)
    valued = opt._value_grad_spec() is not None
    kernels.require("K7's session-row value_spec form" if valued else "K7's session-row form",
                    model.plant)
    kernels.require("K1's session-row emit_terminal form" if valued else "K1's session-row form",
                    model.plant)
    grad = grad_cost_rollout_cols_value if valued else grad_cost_rollout_cols
    cost = cost_rollout_cols_emit if valued else cost_rollout_cols
    return (lambda *a: grad(model, *a), lambda *a: cost(model, *a), lambda dyn: (),
            model.param_keys)
