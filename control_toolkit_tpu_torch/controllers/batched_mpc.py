"""Batched MPC: B independent control loops advanced by one step a tick
(counterpart of control_toolkit_tpu/controllers/batched_mpc.py).

One card serves B independent MPC sessions (robots, simulator instances,
clients) with one kernel launch a tick for all of them.  Slots are fully
independent: each has its own random stream (a generator seeded with
``utils/rng.py:slot_seed(seed, i)``, the counterpart of ``fold_in(key,
i)``), warm start, attributes and, with ``per_slot_dyn``, its own dynamics
constants; a boolean mask freezes the slots that have no pending request,
so an idle session keeps its warm start and its random stream exactly.

The session kinds ported, each over its batched kernel:

* semi-fused MPPI over an ODE model: one K4 launch a tick
  (``MPPIOptimizer._make_batched_semi_fused_step``), with a learned value
  terminal (``attach_value_terminal``) one of K4's emit_terminal form;
* fully-fused CEM (``fully_fused: true``, warmup off): one K6 launch an
  outer iteration (``CEMOptimizer._make_batched_fused_cem_step``);
* semi-fused ``mppi-var`` over an ODE model: MPPI's K4 launch a tick on
  each slot's draws scaled by its own adaptive stdev, then each session's
  stdev step (``MPPIVarOptimizer._make_batched_var_step``), with a learned
  value terminal on K4's emit_terminal form;
* plain MPPI over a learned model, one launch a tick of its kernel's
  session-row form: an MLP (K11), a GRU or LSTM (K13, each session's
  rollouts from its own hidden), ``"ODE+res"`` (K12, ``per_slot_dyn``
  over the base's constants) or a sparse GP (K14)
  (``MPPIOptimizer._batched_columns_step_from_kernel``); with a learned
  value terminal, over the MLP, ``"ODE+res"`` or the GP, one launch of
  that form's emit_terminal form;
* any RPGD variant or ``gradient-tf`` (warmup off) over an ODE, a float32
  MLP, ``"ODE+res"`` or a sparse GP: an Adam iteration is one launch of
  the session-row form of K7, K8, K9 or K10 and the final scoring one of
  K1's, K11's, K12's or K14's (``RPGDOptimizer._make_batched_rpgd_step``,
  ``GradientOptimizer._make_batched_gradient_step``); ``per_slot_dyn``
  over an ODE's or the residual base's constants.

A recurrent model's per-slot hidden (``slot_hidden``, ``[B, 1, Hi]`` a
cell) advances each tick with the applied control, in one batched cell
step over the B slots; a frozen slot keeps its hidden bit for bit, and
``reset_slot`` zeroes the slot's alone.

Every other configuration raises ``NotImplementedError`` naming what is
missing (ROADMAP A9): the vmapped per-slot step that the JAX package
takes for everything else (modular CEM, an RPGD or gradient fleet with
warmup or over a recurrent net, every ``cem-gmm``, ``cma-es``,
``cem-naive-grad`` and ``cem-grad-bharadhwaj`` fleet, a modular
``mppi-var`` fleet, a user's ``force_scan: true``, logging), the slot
mesh and a learned value terminal
on any other fleet (CEM's and a recurrent MPPI fleet's vmapped per-slot
step, and a gradient fleet's where the post-terminal hook is not a plain
tanh-MLP V: the RPGD and gradient-tf fleets over the ODE, the MLP,
``"ODE+res"`` and the GP take such a V in the session-row value_spec forms
of K7-K10).  Nothing falls back to a per-slot loop or to the CPU.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.optimizers.base import _not_ported, batched_kernel_core_ok
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.rng import make_generator, slot_seed

logger = logging.getLogger(__name__)


def _is_state(v) -> bool:
    """A state record (a NamedTuple such as RPGDState's AdamState), not the
    slots' tuple of generators."""
    return isinstance(v, tuple) and hasattr(v, "_fields")


def _stack_states(states: list):
    """One state per slot -> the batched state: tensors stacked on a new
    leading axis, the generators a tuple, host ints a numpy array, nested
    records field by field."""
    def stack(vals):
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals)
        if isinstance(vals[0], torch.Generator):
            return tuple(vals)
        if _is_state(vals[0]):
            return _stack_states(vals)
        return np.asarray(vals)

    return type(states[0])(*(stack(list(vals)) for vals in zip(*states)))


def _set_slot(full, one, i: int):
    """``full`` with slot ``i`` replaced by ``one`` (a copy)."""
    if _is_state(full):
        return type(full)(*(_set_slot(f, o, i) for f, o in zip(full, one)))
    if isinstance(full, tuple):
        return full[:i] + (one,) + full[i + 1:]
    full = full.clone() if isinstance(full, torch.Tensor) else full.copy()
    full[i] = one
    return full


@registry.controllers.register("batched-mpc")
class BatchedMPCController(MPCController):
    """B-slot MPC controller: ``configure(num_slots=B, ...)``, then
    ``step_batch(s [B,S], mask [B], attrs_batch) -> u [B,U]``; the scalar
    ``step`` drives slot 0."""

    def configure(self, *args, num_slots: int = 1, mesh=None, slot_axis=None,
                  per_slot_dyn=(), **kwargs) -> None:
        """``per_slot_dyn`` names scalar dynamics constants (keys of the
        predictor's params, e.g. cartpole ``L``) that vary per session: each
        slot plans against its own model.  They start at the predictor's
        defaults, change per slot through ``update_slot_dyn`` and reach the
        kernel as the sessions' packed parameters, so a change rebuilds
        nothing."""
        if mesh is not None or slot_axis is not None:
            raise _not_ported("the slot mesh (configure(mesh=..., slot_axis=...))")
        # The call, kept so that attach_value_terminal can configure again
        # and build the batched step against the wrapped cost.
        self._configure_stash = (args, dict(
            kwargs, optimizer_config=(dict(kwargs["optimizer_config"])
                                      if kwargs.get("optimizer_config") is not None else None),
            num_slots=num_slots, per_slot_dyn=per_slot_dyn))
        super().configure(*args, **kwargs)
        self.num_slots = B = int(num_slots)
        if B < 1:
            raise ValueError(f"num_slots must be at least 1, got {num_slots}")
        opt = self.optimizer
        pred = getattr(self.predictor, "predictor", self.predictor)
        self._per_slot_dyn = tuple(per_slot_dyn)
        # A residual predictor's constants are its base's, under dyn["base"].
        base = getattr(pred, "base", pred)
        self._dyn_subtree = "base" if base is not pred else None
        defaults = base.default_params()
        # A net's or a GP's params are tensor subtrees (and a recurrent net's
        # hidden a tuple): no scalar constants.
        scalars = sorted(k for k, v in defaults.items()
                         if not isinstance(v, (dict, tuple)) and np.ndim(v) == 0)
        for k in self._per_slot_dyn:
            if k not in scalars:
                raise ValueError(f"per_slot_dyn key {k!r} is not a scalar dynamics constant of "
                                 f"this predictor (have: {scalars})")
        self._slot_dyn_defaults = {k: float(defaults[k]) for k in self._per_slot_dyn}
        self.slot_dyn: Dict[str, np.ndarray] = {
            k: np.full((B,), v, np.float32) for k, v in self._slot_dyn_defaults.items()
        }

        self._stateful = self.predictor.is_stateful
        if self._batched_kernel_eligible():
            self._kstep, _ = opt._make_batched_semi_fused_step(B, per_slot_dyn=self._per_slot_dyn)
            kind = "semi-fused MPPI (K4)"
        elif self._batched_neural_eligible():
            self._kstep, _ = opt._make_batched_neural_step(B)
            kind = "MPPI over an MLP (K11's session rows)"
        elif self._batched_recurrent_eligible():
            self._kstep, _ = opt._make_batched_recurrent_step(B)
            kind = f"MPPI over a {pred.arch['kind'].upper()} (K13's session rows)"
        elif self._batched_residual_eligible():
            self._kstep, _ = opt._make_batched_residual_step(B, per_slot_dyn=self._per_slot_dyn)
            kind = "MPPI over ODE+res (K12's session rows)"
        elif self._batched_gp_eligible():
            self._kstep, _ = opt._make_batched_gp_step(B)
            kind = "MPPI over a sparse GP (K14's session rows)"
        elif self._batched_rpgd_eligible():
            self._kstep, _ = opt._make_batched_rpgd_step(B, per_slot_dyn=self._per_slot_dyn)
            kind = f"{opt.registered_name} (gradient and cost kernels' session rows)"
        elif self._batched_gradient_eligible():
            self._kstep, _ = opt._make_batched_gradient_step(B, per_slot_dyn=self._per_slot_dyn)
            kind = "gradient-tf (gradient and cost kernels' session rows)"
        elif self._batched_fused_cem_eligible():
            self._kstep, _ = opt._make_batched_fused_cem_step(B, per_slot_dyn=self._per_slot_dyn)
            kind = "fully-fused CEM (K6)"
        elif self._batched_var_eligible():
            self._kstep, _ = opt._make_batched_var_step(B, per_slot_dyn=self._per_slot_dyn)
            kind = "mppi-var semi-fused (K4)"
        else:
            raise self._refusal()
        logger.info(f"batched-mpc: {kind}, B={B} x K={opt.num_rollouts} in one launch"
                    + (f", per-slot dyn {list(self._per_slot_dyn)}" if self._per_slot_dyn else ""))
        self.slot_states = self._init_slot_states()
        if self._stateful:
            self.slot_hidden = self._zero_hidden()
        self.slot_attrs: Dict[str, np.ndarray] = {
            k: np.full((B,), float(torch.as_tensor(v).reshape(-1)[0]), np.float32)
            for k, v in self.variable_parameters.items()
        }

    def _batched_kernel_eligible(self) -> bool:
        """K4's gate (JAX ``batched_mpc.py:459`` without its TPU
        conjuncts): plain semi-fused MPPI over an ODE model of a device
        plant, and K a multiple of 8 (the sessions' rollout order); a
        post-terminal hook (a learned value terminal) is admitted, K4's
        emit_terminal form carrying it."""
        from control_toolkit_tpu_torch.ops.counter_prng import ROWS
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        opt = self.optimizer
        return (
            self._plain_mppi()
            and batched_kernel_core_ok(opt, force_scan=opt.force_scan,
                                       stateful=self._stateful, post_ok=True)
            and opt.semi_fused
            and ode.compatible_model(opt)
            and opt.num_rollouts % ROWS == 0
        )

    def _plain_mppi(self) -> bool:
        """Plain MPPI (not a variant) without ``bounded_update``: the update
        every MPPI batched step computes."""
        from control_toolkit_tpu_torch.optimizers.mppi import MPPIOptimizer

        opt = self.optimizer
        return type(opt) is MPPIOptimizer and not opt.bounded_update

    def _batched_neural_like_eligible(self, recurrent: bool) -> bool:
        """The learned nets' gate (JAX ``batched_mpc.py:484`` without its
        TPU conjuncts): plain MPPI over a float32 net whose cost the device
        plant evaluates (``neural.compatible_model``), no ``per_slot_dyn``
        (the net's weights are shared: it has no scalar constants), and
        ``recurrent`` the net's form: an MLP (K11) or a GRU/LSTM (K13)."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import neural

        opt = self.optimizer
        pred = getattr(self.predictor, "predictor", self.predictor)
        return (
            self._plain_mppi()
            and not self._per_slot_dyn
            # post_ok for the MLP alone (K11's emit_terminal form), as JAX
            # batched_mpc.py:500-504: a valued recurrent fleet is the vmapped
            # per-slot step's.
            and batched_kernel_core_ok(opt, force_scan=opt.force_scan, post_ok=not recurrent)
            and neural.compatible_model(opt)
            and pred.recurrent == recurrent
        )

    def _batched_neural_eligible(self) -> bool:
        return self._batched_neural_like_eligible(recurrent=False)

    def _batched_recurrent_eligible(self) -> bool:
        return self._batched_neural_like_eligible(recurrent=True)

    def _batched_residual_eligible(self) -> bool:
        """K12's gate (JAX ``batched_mpc.py:513``): plain MPPI over an
        ``"ODE+res"`` predictor of a device plant; ``per_slot_dyn`` names
        base constants, carried in the sessions' rows."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import residual

        opt = self.optimizer
        return (self._plain_mppi()
                # post_ok: K12's emit_terminal form (JAX batched_mpc.py:528-530)
                and batched_kernel_core_ok(opt, force_scan=opt.force_scan, post_ok=True)
                and residual.compatible_model(opt))

    def _batched_gp_eligible(self) -> bool:
        """K14's gate (JAX ``batched_mpc.py:536``): plain MPPI over a sparse
        GP of a device plant, no ``per_slot_dyn``."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import gp

        opt = self.optimizer
        return (self._plain_mppi()
                and not self._per_slot_dyn
                # post_ok: K14's emit_terminal form (JAX batched_mpc.py:551-553)
                and batched_kernel_core_ok(opt, force_scan=opt.force_scan, post_ok=True)
                and gp.compatible_model(opt))

    def _batched_grad_eligible(self, is_kind) -> bool:
        """The gradient fleets' gate (JAX ``batched_mpc.py:564`` and ``:641``
        without the TPU tile half): ``is_kind(optimizer)``, warmup is off
        (one Adam trip count for all sessions), and the model is one the
        gradient kernels' session-row forms take
        (``Optimizer._grad_kernel_model_ok``)."""
        opt = self.optimizer
        return (
            is_kind(opt)
            # post_ok: a plain tanh-MLP V rides the session-row value_spec
            # forms (JAX batched_mpc.py:578-582, :653-657)
            and batched_kernel_core_ok(opt, force_scan=opt.force_scan,
                                       stateful=self._stateful,
                                       post_ok=opt._value_grad_spec() is not None)
            and not opt.warmup
            and opt._grad_kernel_model_ok(bool(self._per_slot_dyn))
        )

    def _batched_rpgd_eligible(self) -> bool:
        """Any RPGD variant (their ``_resample`` and entropy bonus apply in
        the batched step too)."""
        from control_toolkit_tpu_torch.optimizers.rpgd import RPGDOptimizer

        return self._batched_grad_eligible(lambda opt: isinstance(opt, RPGDOptimizer))

    def _batched_gradient_eligible(self) -> bool:
        """Plain gradient-tf."""
        from control_toolkit_tpu_torch.optimizers.gradient import GradientOptimizer

        return self._batched_grad_eligible(lambda opt: type(opt) is GradientOptimizer)

    def _batched_fused_cem_eligible(self) -> bool:
        """K6's gate (JAX ``batched_mpc.py:589`` without its TPU
        conjuncts): plain CEM with ``fully_fused``, warmup off, an ODE
        model of a device plant, and K a multiple of 8 (K6's counter
        layout)."""
        from control_toolkit_tpu_torch.ops.counter_prng import ROWS
        from control_toolkit_tpu_torch.optimizers.cem import CEMOptimizer
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        opt = self.optimizer
        return (
            type(opt) is CEMOptimizer
            and opt.fully_fused
            and batched_kernel_core_ok(opt, force_scan=opt.force_scan,
                                       stateful=self._stateful)
            and not opt.warmup
            and ode.compatible_model(opt)
            and opt.num_rollouts % ROWS == 0
        )

    def _batched_var_eligible(self) -> bool:
        """The mppi-var fleet's gate (JAX ``batched_mpc.py:613`` without its
        TPU conjuncts): mppi-var, semi-fused, an ODE model of a device
        plant and K a multiple of 8, K4's conditions; a post-terminal hook
        is admitted (K4's emit_terminal form; V joins each session's costs
        before its softmax and its adaptation)."""
        from control_toolkit_tpu_torch.ops.counter_prng import ROWS
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode
        from control_toolkit_tpu_torch.optimizers.mppi_var import MPPIVarOptimizer

        opt = self.optimizer
        return (
            type(opt) is MPPIVarOptimizer
            and batched_kernel_core_ok(opt, force_scan=opt.force_scan,
                                       stateful=self._stateful, post_ok=True)
            and opt.semi_fused
            and ode.compatible_model(opt)
            and opt.num_rollouts % ROWS == 0
        )

    def _refusal(self) -> NotImplementedError:
        """The missing piece that this configuration's batched step needs."""
        from control_toolkit_tpu_torch.optimizers.cem import CEMOptimizer
        from control_toolkit_tpu_torch.optimizers.gradient import GradientOptimizer
        from control_toolkit_tpu_torch.optimizers.rpgd import RPGDOptimizer

        from control_toolkit_tpu_torch.models.ensemble_predictor import EnsemblePredictor
        from control_toolkit_tpu_torch.optimizers.cem_gmm import CEMGMMOptimizer
        from control_toolkit_tpu_torch.optimizers.cem_grad_bharadhwaj import (
            CEMGradBharadhwajOptimizer,
        )
        from control_toolkit_tpu_torch.optimizers.cem_naive_grad import CEMNaiveGradOptimizer
        from control_toolkit_tpu_torch.optimizers.cma_es import CMAESOptimizer
        from control_toolkit_tpu_torch.optimizers.mppi import RECURRENT_VALUE_FLEET
        from control_toolkit_tpu_torch.optimizers.mppi_var import MPPIVarOptimizer

        # The JAX package runs these fleets as the vmapped per-slot step
        # alone (its batched dispatch has no kernel branch for them).
        vmapped_only = (CEMGMMOptimizer, CMAESOptimizer, CEMNaiveGradOptimizer,
                        CEMGradBharadhwajOptimizer)

        opt = self.optimizer
        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        if isinstance(getattr(self.predictor, "predictor", self.predictor), EnsemblePredictor):
            # The ensemble kernels have no session-row form in either package.
            return _not_ported("the vmapped per-slot batched step (taken for a fleet over an "
                               "ensemble predictor)")
        if opt.force_scan or opt.optimizer_logging or opt.calculate_optimal_trajectory:
            return _not_ported("the vmapped per-slot batched step (taken for force_scan, logging "
                               "or the optimal trajectory)")
        if isinstance(opt, vmapped_only):
            return _not_ported(f"the vmapped per-slot batched step (taken for every "
                               f"{opt.registered_name} fleet: it has no batched kernel step)")
        grad_fleet = isinstance(opt, (RPGDOptimizer, GradientOptimizer))
        if getattr(cf, "post_terminal_cost", None) is not None and not (
                grad_fleet and opt._value_grad_spec() is not None):
            if grad_fleet:
                return _not_ported("the vmapped per-slot batched step (taken for a gradient "
                                   "fleet whose post-terminal hook is not a plain tanh-MLP "
                                   "value net)")
            if isinstance(opt, CEMOptimizer):
                return _not_ported("a learned value terminal in a batched CEM fleet (the vmapped "
                                   "per-slot batched step: K6 and the modular batched step "
                                   "carry no value terminal)")
            pred = getattr(self.predictor, "predictor", self.predictor)
            if self._plain_mppi() and getattr(pred, "recurrent", False):
                return _not_ported(RECURRENT_VALUE_FLEET)
            return _not_ported("a learned value terminal in this batched configuration (the "
                               "vmapped per-slot batched step)")
        if grad_fleet:
            why = "warmup on" if opt.warmup else "a model the gradient kernels do not take"
            return _not_ported(f"the vmapped per-slot batched step (taken for "
                               f"{opt.registered_name} with {why})")
        if type(opt) is CEMOptimizer and not opt.fully_fused:
            return _not_ported("the vmapped per-slot batched step (taken for modular CEM)")
        if type(opt) is MPPIVarOptimizer:
            return _not_ported("the vmapped per-slot batched step (taken for mppi-var off K4's "
                               "conditions: semi_fused off, a model other than an ODE of a "
                               "device plant, or K not a multiple of 8)")
        return _not_ported(f"the vmapped per-slot batched step ({opt.registered_name}, "
                           f"K={opt.num_rollouts})")

    # ---- slot management ---------------------------------------------------
    def _slot_generator(self, i: int) -> torch.Generator:
        return make_generator(slot_seed(self.optimizer._seed, i), self.device)

    def _init_slot_states(self):
        opt = self.optimizer
        return _stack_states([opt._init_state(self._slot_generator(i))
                              for i in range(self.num_slots)])

    def _zero_hidden(self):
        """A recurrent model's per-slot hidden, every slot zero: per cell
        ``[B, 1, Hi]`` (``_rnn_state0`` at batch B)."""
        pred = self.predictor.predictor
        return tuple(h[:, None, :] for h in pred._rnn_state0(pred.arch["hiddens"],
                                                               self.num_slots,
                                                               device=self.device))

    def reset_slot(self, i: int) -> None:
        """Slot ``i``'s initial warm start and random stream, as its first
        tick had them, and a recurrent model's hidden zeroed for that slot
        alone (it may carry the divergence or a stale session); its
        dynamics constants are kept (``reset_slot_dyn``)."""
        new = self.optimizer._init_state(self._slot_generator(i))
        self.slot_states = type(new)(*(_set_slot(full, one, i)
                                       for full, one in zip(self.slot_states, new)))
        if self._stateful:
            self.slot_hidden = tuple(_set_slot(h, torch.zeros_like(h[i]), i)
                                     for h in self.slot_hidden)

    def update_slot_dyn(self, i: int, updated: Optional[Dict]) -> None:
        """Update slot ``i``'s per-session dynamics constants (keys named in
        ``configure(per_slot_dyn=...)``), e.g. commit a per-robot sysid
        result; no rebuild.  The whole update is validated before any key
        is committed: a rejected value (one NaN constant) must not leave the
        slot planning with a half-applied model."""
        staged = []
        for k, v in (updated or {}).items():
            if k not in self.slot_dyn:
                logger.warning(f"slot {i}: dynamics constant {k!r} was not named in "
                               "per_slot_dyn at configure time; ignored")
                continue
            flat = np.asarray(v, np.float32).reshape(-1)
            if flat.shape[0] != 1:
                logger.warning(f"slot {i}: dynamics constant {k!r} has {flat.shape[0]} "
                               "elements; per-slot constants are scalars, using element 0")
            val = float(flat[0])
            if not np.isfinite(val):
                raise ValueError(f"slot {i}: dynamics constant {k!r} must be finite, got {v!r}")
            staged.append((k, val))
        for k, val in staged:
            self.slot_dyn[k][i] = val

    def reset_slot_dyn(self, i: int) -> None:
        """Slot ``i``'s dynamics constants back to the predictor's defaults
        (a slot handed to a new client), unlike ``reset_slot``, which keeps
        the model."""
        for k, v in self._slot_dyn_defaults.items():
            self.slot_dyn[k][i] = v

    def update_slot_attributes(self, i: int, updated: Optional[Dict]) -> None:
        for k, v in (updated or {}).items():
            if k not in self.slot_attrs:
                logger.warning(f"slot {i}: attribute {k!r} was not configured at construction; "
                               "ignored (batched attrs are fixed-key)")
                continue
            flat = np.asarray(v, np.float32).reshape(-1)
            if flat.shape[0] != 1:
                logger.warning(f"slot {i}: attribute {k!r} has {flat.shape[0]} elements; "
                               "batched slots hold scalars, using element 0")
            self.slot_attrs[k][i] = float(flat[0])

    # ---- hot path ------------------------------------------------------------
    def _freeze(self, mask_np: np.ndarray, u, new, old):
        """Frozen slots keep their state exactly (their generators drew
        nothing) and emit u = 0."""
        mask = torch.as_tensor(mask_np, device=self.device)

        def keep(n, o):
            if isinstance(n, torch.Tensor):
                return torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
            if isinstance(n, np.ndarray):
                return np.where(mask_np.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
            if _is_state(n):  # e.g. the Adam state: its moments and counters
                return type(n)(*(keep(a, b) for a, b in zip(n, o)))
            return n

        return torch.where(mask[:, None], u, 0.0), type(new)(*(keep(n, o) for n, o in zip(new, old)))

    def _dyn_with_slots(self, dyn: Dict) -> Dict:
        """``dyn`` with the per-slot constants ``[B]`` laid over it: at the
        top, or in a residual predictor's ``base``."""
        slot = {k: torch.as_tensor(v, device=self.device) for k, v in self.slot_dyn.items()}
        if self._dyn_subtree is None:
            return dict(dyn, **slot)
        return dict(dyn, **{self._dyn_subtree: dict(dyn[self._dyn_subtree], **slot)})

    def step_batch(self, s_batch: np.ndarray, mask: Optional[np.ndarray] = None,
                   updated_attributes: Optional[List[Optional[Dict]]] = None) -> np.ndarray:
        B = self.num_slots
        if updated_attributes:
            if len(updated_attributes) > B:
                logger.warning(f"step_batch got {len(updated_attributes)} attribute entries "
                               f"for {B} slots; extras ignored")
            for i, upd in enumerate(updated_attributes[:B]):
                self.update_slot_attributes(i, upd)
        if self.cost_function.update_cost_parameters_from_config():
            self._cost_params = None
        params = self._assemble_params()
        dyn = self._dyn_with_slots(params["dyn"])
        mask_np = np.ones((B,), bool) if mask is None else np.asarray(mask, bool).reshape(B)
        s = torch.as_tensor(np.asarray(s_batch, np.float32).reshape(B, 1, -1), device=self.device)
        attrs = {k: torch.as_tensor(v, device=self.device) for k, v in self.slot_attrs.items()}
        hidden = (self.slot_hidden,) if self._stateful else ()
        u, new, _ = self._kstep(self.slot_states, s, dyn, params["cost"], attrs, mask_np, *hidden)
        if self._stateful:
            self.slot_hidden = self._advance_hidden(dyn["net"], s, u, mask_np)
        u, self.slot_states = self._freeze(mask_np, u, new, self.slot_states)
        u_host = u.cpu().numpy()
        # Per-slot NaN guard: a diverged slot commands zero and resets alone.
        bad = ~np.all(np.isfinite(u_host), axis=-1)
        for i in np.nonzero(bad)[0]:
            logger.warning(f"slot {i} produced non-finite control; resetting")
            self.reset_slot(int(i))
        u_host[bad] = 0.0
        return u_host

    def _advance_hidden(self, net, s, u, mask_np):
        """Every slot's hidden advanced with its applied (pre-freeze) control
        in one batched cell step (JAX ``batched_mpc.py:290-306``; the
        reference's predictor.update); a frozen slot keeps its hidden bit for
        bit."""
        pred = self.predictor.predictor
        _, h_new = pred._rnn_apply(net, torch.cat([s[:, 0, :], u], dim=-1),
                                   tuple(h[:, 0, :] for h in self.slot_hidden))
        mask = torch.as_tensor(mask_np, device=self.device)[:, None, None]
        return tuple(torch.where(mask, hn[:, None, :], h)
                     for hn, h in zip(h_new, self.slot_hidden))

    def step(self, s, time=None, updated_attributes: Optional[Dict] = None):
        """The scalar controller's surface: drive slot 0."""
        B = self.num_slots
        s_batch = np.zeros((B, np.asarray(s).reshape(-1).shape[0]), np.float32)
        s_batch[0] = np.asarray(s, np.float32).reshape(-1)
        mask = np.zeros((B,), bool)
        mask[0] = True
        return self.step_batch(s_batch, mask, [updated_attributes] + [None] * (B - 1))[0]

    def controller_reset(self) -> None:
        self.slot_states = self._init_slot_states()
        if self._stateful:
            self.slot_hidden = self._zero_hidden()
