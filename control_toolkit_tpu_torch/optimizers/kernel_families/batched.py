"""The batched gradient fleets' kernel binding (counterpart of
control_toolkit_tpu/optimizers/kernel_families/batched.py).

The shared preamble of the batched-mpc RPGD and gradient-tf steps: binds
the predictor and the cost into the session-row forms of a gradient
kernel and its cost kernel, and the sessions' packer, by the predictor's
family (each family's ``batched_kernels``):

* an ODE model: K7's and K1's forms, the dynamics constants in the
  sessions' rows (``per_slot_dyn`` among them);
* an MLP: K8's and K11's, the weights shared, read from ``dyn["net"]``;
* a sparse GP: K10's and K14's, the GP's operands shared, from
  ``dyn["gp"]``;
* ``"ODE+res"``: K9's and K12's, the base's constants in the rows
  (``per_slot_dyn`` among them), the residual's weights shared, from
  ``dyn["res"]``.

The operands read from ``dyn`` at every call, a weight swap, a GP hot-swap
or a re-sysid rebuilds nothing.  The JAX binder's tile choice (a grad tile
dividing B*K) has no counterpart: the forms mask a ragged B*K.

A learned value terminal whose V is a plain tanh MLP (``_value_grad_spec``)
keeps this path, as in JAX ``batched.py:125-152``: each family's
``batched_kernels`` then gives its gradient kernel's session-row
value_spec form, to which ``gcall`` appends V's operands (the scale folded
into the last layer, read from ``cost`` at every call: a re-fit rebuilds
nothing; all sessions share V), and its cost kernel's session-row
emit_terminal form, whose terminal states ``ccall`` scores with
``scale * V(x_H) / (H+1)`` per session outside the kernel.
"""
from __future__ import annotations

from control_toolkit_tpu_torch.models.gp_predictor import GPPredictor
from control_toolkit_tpu_torch.models.neural_predictor import NeuralPredictor
from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor


def bind_batched_grad_kernels(opt, num_slots: int, per_slot_dyn=()):
    """``(gcall, ccall, pack)`` for a fleet of ``num_slots`` sessions:
    ``gcall(s0 [B*K,S], Q [B*K,H,U], pvec_b [B,N], dyn, cost) -> (cost
    [B,K], dQ [B*K,H,U])`` is one launch of the gradient form, ``ccall(...)
    -> cost [B,K]`` one of the cost form (``cost``: the cost's params, V's
    among them), and ``pack(u_prev_b [B,U], dyn, cost, attrs) -> pvec_b``
    packs each session's row (``make_slot_packer``; a residual model's
    constants read from ``dyn["base"]``).

    Refuses, as the JAX binder does, per-slot dynamics over a net or a GP
    (their parameters are shared by the sessions) and a recurrent net (its
    backward would need the per-step hidden history), with ValueError; and
    any post-terminal hook but a plain tanh-MLP V, which the JAX package
    sends to the vmapped per-slot step, with NotImplementedError."""
    from control_toolkit_tpu_torch.optimizers import kernel_families as kf
    from control_toolkit_tpu_torch.optimizers.base import (
        _not_ported, make_slot_packer, split_slot_keys,
    )

    pred = getattr(opt.predictor, "predictor", opt.predictor)
    cf = getattr(opt.cost_function, "cost_function", opt.cost_function)
    neural, gp = isinstance(pred, NeuralPredictor), isinstance(pred, GPPredictor)
    if (neural or gp) and per_slot_dyn:
        raise ValueError("per-slot dynamics require an ODE predictor: learned-model "
                         "parameters ride as shared operands")
    if neural and pred.recurrent:
        raise ValueError("recurrent predictors keep the vmapped scan path (their backward "
                         "needs the per-step hidden history)")
    valued = opt._value_grad_spec() is not None
    if cf.post_terminal_cost is not None and not valued:
        raise _not_ported("the vmapped per-slot batched step (taken for a gradient fleet whose "
                          "post-terminal hook is not a plain tanh-MLP value net)")
    fam = next((f for f in kf.GRAD_ORDER if f.can_use_grad(opt)), None)
    if fam is None:
        raise ValueError("the batched gradient kernels cover an ODE, a float32 MLP, a sparse "
                         "GP or ODE+res over the cost their device plant evaluates")
    grad, cost_form, extra, param_keys = fam.batched_kernels(opt)
    B = int(num_slots)
    _, slot_keys = split_slot_keys(param_keys, per_slot_dyn)
    pack = make_slot_packer(param_keys, slot_keys, cf.attr_defaults, B, opt.device)
    if isinstance(pred, ResidualPredictor):
        # The packer reads scalar dyn leaves; the residual's are its base's.
        inner_pack = pack

        def pack(u_prev_b, dyn, cost, attrs):
            return inner_pack(u_prev_b, dyn["base"], cost, attrs)

    if not valued:
        def gcall(s0, Q, pvec_b, dyn, cost):
            return grad(s0, Q, pvec_b, *extra(dyn))

        def ccall(s0, Q, pvec_b, dyn, cost):
            return cost_form(s0, Q, pvec_b, *extra(dyn))

        return gcall, ccall, pack

    inv_h1 = 1.0 / (opt.mpc_horizon + 1)

    def gcall(s0, Q, pvec_b, dyn, cost):
        return grad(s0, Q, pvec_b, *extra(dyn), opt._flatten_value_ops({"cost": cost}))

    def ccall(s0, Q, pvec_b, dyn, cost):
        costs, x_term = cost_form(s0, Q, pvec_b, *extra(dyn))
        return costs + cf.post_terminal_cost(x_term, {"cost": cost}) * inv_h1

    return gcall, ccall, pack
