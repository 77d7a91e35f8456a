"""Optimizer base class (counterpart of control_toolkit_tpu/optimizers/base.py).

Same constructor surface, ``configure(num_states, num_control_inputs)``,
``step(s, time) -> u`` and ``logging_values`` contract as the JAX package.
An optimizer builds a step function ``step_fn(state, s, params) -> (u,
new_state, diagnostics)`` over an explicit state; everything that may
change between steps (cost weights, attributes, dynamics constants)
arrives in ``params`` as tensors on the optimizer's device.

Ported so far is what MPPI, RPGD, gradient-tf and the sampling zoo need,
with the ensemble's ``risk_weight`` (a disagreement penalty on every
trajectory cost) and ``robust_eval`` (every plan scored under every
member), a learned value terminal's hooks (``_post_terminal_fn``,
``_value_grad_spec``, ``_flatten_value_ops``, ``_finalize_cost_kernel``),
``remat`` (the fused loop's steps under ``torch.utils.checkpoint`` on the
autograd path), the heuristic-policy warm start (``initial_guess_policy``:
``_policy_plan`` and each class's ``_apply_policy_guess``) and the
``optimal_trajectory`` / ``summed_stage_cost`` diagnostics of
``calculate_optimal_trajectory``.  Mesh sharding is not ported: it raises
``NotImplementedError`` (ROADMAP).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from control_toolkit_tpu_torch.utils.device import place, resolve_device
from control_toolkit_tpu_torch.utils.rng import derive_seed, make_generator

logger = logging.getLogger(__name__)


def _not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to control_toolkit_tpu_torch yet (ROADMAP)"
    )


def partition_packed_keys(param_keys, extra_slot_keys=()):
    """``(shared_keys, slot_keys)`` of the packed scalar params over
    already-prefixed extras (``d_<name>`` / ``c_<name>``): attributes
    (``a_*``) and the previous control (``__u_prev_*``) are always per
    session, the extras join them."""
    slot_prefixes = ("a_", "__u_prev_")
    extra = frozenset(extra_slot_keys)
    unknown = extra - set(param_keys)
    if unknown:
        raise ValueError(f"per-slot keys {sorted(unknown)} not in "
                         "the packed scalar params")
    slot_keys = [k for k in param_keys if k.startswith(slot_prefixes) or k in extra]
    shared_keys = [k for k in param_keys if k not in slot_keys]
    return shared_keys, slot_keys


def split_slot_keys(param_keys, per_slot_dyn=(), per_slot_cost=()):
    """``partition_packed_keys`` from bare dynamics and cost names."""
    return partition_packed_keys(
        param_keys,
        tuple(f"d_{k}" for k in per_slot_dyn) + tuple(f"c_{k}" for k in per_slot_cost),
    )


def make_slot_packer(param_keys, slot_keys, attr_defaults, B: int, device):
    """The batched kernels' parameter packer: ``pack(u_prev_b [B,U], dyn,
    cost, attrs) -> pvec_b [B, N]``, row b session b's packed vector in the
    single-session ``pack``'s key order (``Optimizer._soa_bindings``).
    Shared values (dynamics constants, cost weights) are broadcast over the
    sessions; the ``slot_keys`` (attributes, ``__u_prev_*``, per-slot
    ``d_*``/``c_*``) take a ``[B]`` tensor, or a scalar broadcast (a missing
    attribute takes the cost's default).  The kernels read a session's row
    by index: on the card per-session scalars are not lane rows."""
    slot = frozenset(slot_keys)
    attr_defaults = dict(attr_defaults)

    def pack(u_prev_b, dyn, cost, attrs):
        cols = []
        for k in param_keys:
            if k.startswith("__u_prev_"):
                v = u_prev_b[:, int(k.rsplit("_", 1)[1])]
            elif k.startswith("a_"):
                v = attrs.get(k[2:])
                if v is None:
                    v = float(attr_defaults.get(k[2:], 0.0))
            else:
                v = dyn[k[2:]] if k.startswith("d_") else cost[k[2:]]
            v = torch.as_tensor(v, dtype=torch.float32, device=device)
            if k not in slot and v.ndim != 0:
                raise ValueError(f"shared parameter {k!r} must be a scalar; name it per slot")
            cols.append(torch.broadcast_to(v.reshape(-1), (B,)))
        return torch.stack(cols, dim=1)

    return pack


def slot_scalars(rows: Dict[str, np.ndarray], i: int, device) -> Dict[str, torch.Tensor]:
    """Slot ``i``'s values of per-slot host rows ``{name: [B]}`` (a fleet's
    attributes or ``per_slot_dyn`` constants) as 0-d float32 tensors on
    ``device``: what the single-session step of the per-slot fleet step
    reads where ``make_slot_packer``'s batched steps read row i, and what
    the slot's own controller would hold."""
    return {k: torch.tensor(float(v[i]), dtype=torch.float32, device=device)
            for k, v in rows.items()}


def batched_kernel_core_ok(opt, *, force_scan: bool, stateful: bool = False,
                           post_ok: bool = False) -> bool:
    """The conjunction every batched-kernel gate shares: no user
    ``force_scan`` opt-out, a stateless predictor, no logging or optimal
    trajectory (per-session diagnostics) and no post-terminal hook unless
    ``post_ok`` (the gate's kernel carries a learned value terminal: K4's
    ``emit_terminal`` form).  The JAX gate's K-sharding mesh conjunct has
    no counterpart: the port refuses a mesh."""
    return (
        not force_scan
        and not stateful
        and not opt.optimizer_logging
        and not opt.calculate_optimal_trajectory
        and (post_ok or opt._post_terminal_fn() is None)
    )


class Optimizer:
    registered_name: str = "template"

    def __init__(
        self,
        predictor,
        cost_function,
        control_limits: Tuple[np.ndarray, np.ndarray],
        optimizer_logging: bool = False,
        seed: Optional[int] = None,
        num_rollouts: int = 32,
        mpc_horizon: int = 35,
        computation_library: Any = None,  # accepted for config compatibility
        calculate_optimal_trajectory: bool = False,
        remat: bool = False,
        force_scan: bool = False,
        logging_lazy: bool = False,
        initial_guess_policy=None,
        risk_weight: float = 0.0,
        robust_eval: Optional[str] = None,
        **kwargs,
    ):
        # Rematerialize the fused loop's steps under torch.autograd (memory
        # for operations at large K*H); the kernels ignore it.
        self.remat = bool(remat)
        # Heuristic-policy warm start: a callable (x [S], params) -> u [U]
        # rolled closed loop through the predictor at the first step after
        # every optimizer_reset; the [H, U] plan seeds the state through the
        # class's ``_apply_policy_guess`` (a class without one ignores it).
        self.initial_guess_policy = initial_guess_policy
        self._policy_seed_pending = False
        # Risk-averse planning: risk_weight * disagreement(s, Q), the
        # predictor's per-rollout epistemic uncertainty (an ensemble's
        # cross-member trajectory std), added to every trajectory cost;
        # the gradient optimizers descend it too.  Needs a predictor with
        # ``disagreement`` (checked at configure).
        self.risk_weight = float(risk_weight)
        # Robust evaluation over the ensemble's members: every plan scored
        # under all E members (``rollout_all_members``) and the member costs
        # aggregated: 'mean', 'worst' or 'cvar:<frac>' (the mean of the
        # worst ceil(frac * E)).  E times the rollouts; composes with
        # risk_weight.
        if robust_eval is not None:
            r = str(robust_eval)
            if not (r in ("mean", "worst") or r.startswith("cvar:")):
                raise ValueError(f"robust_eval must be 'mean', 'worst' or 'cvar:<frac>', "
                                 f"got {robust_eval!r}")
            if r.startswith("cvar:"):
                frac = float(r.split(":", 1)[1])
                if not 0.0 < frac <= 1.0:
                    raise ValueError(f"cvar fraction must be in (0, 1], got {frac}")
        self.robust_eval = robust_eval
        self.predictor = predictor
        self.cost_function = cost_function
        self.num_rollouts = int(num_rollouts)
        self.mpc_horizon = int(mpc_horizon)
        self.optimizer_logging = bool(optimizer_logging)
        self.calculate_optimal_trajectory = bool(calculate_optimal_trajectory)
        self.force_scan = bool(force_scan)
        # Keep diagnostics as device tensors until Controller.get_outputs.
        self.logging_lazy = bool(logging_lazy)

        unknown = set(kwargs) - {"mpc_timestep"}
        if unknown:
            logger.warning(
                f"{self.__class__.__name__}: ignoring unknown config keys "
                f"{sorted(unknown)} (check config_optimizers.yml for typos)"
            )

        self._action_limits = tuple(np.asarray(v, np.float32) for v in control_limits)
        self._seed = derive_seed(seed, context=self.__class__.__name__)
        # Set by the owning controller from its 'device' config key before
        # configure(); every tensor of the optimizer lives there.  An
        # optimizer no controller placed takes the default (the card) there.
        self.device: Optional[torch.device] = None

        self.num_states: Optional[int] = None
        self.num_control_inputs: Optional[int] = None
        self.logging_values: Dict[str, Any] = {}
        self.opt_state: Any = None
        self.u: Any = 0.0
        self.optimal_control_sequence = None
        self.optimal_trajectory: Optional[np.ndarray] = None
        self.summed_stage_cost: Optional[np.ndarray] = None
        self._step_fn = None
        self._build_epoch = 0

    # ---- lifecycle --------------------------------------------------------
    def configure(self, num_states: int, num_control_inputs: int,
                  dt: Optional[float] = None, predictor_specification: Optional[str] = None,
                  default_configure: bool = True, **kwargs) -> None:
        if self.device is None:
            self.device = resolve_device(None)
        self.num_states = int(num_states)
        self.num_control_inputs = int(num_control_inputs)
        self.dt = dt
        pred = getattr(self.predictor, "predictor", self.predictor)
        if self.risk_weight and self._disagreement_fn() is None:
            raise ValueError(
                "risk_weight requires a predictor exposing disagreement() (e.g. an "
                f"'ensemble:<net>:<E>' EnsemblePredictor); got {type(pred).__name__}"
            )
        if self.robust_eval and not hasattr(pred, "rollout_all_members"):
            raise ValueError(
                "robust_eval requires a predictor exposing rollout_all_members() (an "
                f"'ensemble:<net>:<E>' EnsemblePredictor); got {type(pred).__name__}"
            )
        E = getattr(pred, "n_members", None)
        if E and E > 1 and self.num_rollouts > 1 and self.num_rollouts % E and not self.robust_eval:
            # The ensemble-mean dynamics for the whole population would
            # silently replace the trajectory sampling asked for.
            raise ValueError(
                f"num_rollouts={self.num_rollouts} does not divide over the {E} ensemble "
                "members: trajectory sampling needs num_rollouts % n_members == 0 (pick E in "
                "{2,4,8} for power-of-two populations, or set robust_eval to score every "
                "plan under every member instead)"
            )
        low, high = self._action_limits
        self.action_low = torch.as_tensor(low, device=self.device)
        self.action_high = torch.as_tensor(high, device=self.device)
        self._build()
        if default_configure:
            self.optimizer_reset()

    def _build(self) -> None:
        """Build the step function; ``_build_epoch`` counts builds."""
        self._build_epoch += 1
        self._step_fn = self._make_step_fn()

    def _make_step_fn(self):
        raise NotImplementedError

    def _init_state(self, generator: torch.Generator):
        raise NotImplementedError

    def optimizer_reset(self) -> None:
        """Fresh state; the noise stream restarts from the seed."""
        generator = make_generator(self._seed, self.device, context=self.__class__.__name__)
        self.opt_state = self._init_state(generator)
        self.u = torch.zeros(self.num_control_inputs, dtype=torch.float32, device=self.device)
        # Every reset (the NaN guard's too) re-arms the policy warm start.
        self._policy_seed_pending = (self.initial_guess_policy is not None
                                     and hasattr(self, "_apply_policy_guess"))

    # ---- heuristic-policy warm start ---------------------------------------
    def _policy_plan(self, s: torch.Tensor, params: Dict) -> torch.Tensor:
        """The closed-loop rollout of ``initial_guess_policy`` from ``s[:1]``
        through the predictor's ``single_step``: H controls, each
        ``policy(x[0], params)`` reshaped to ``[U]`` and clipped to the
        action box, ``[H, U]`` (JAX ``base.py:359-390``).  Plain torch on
        the optimizer's device, once after each reset."""
        step = getattr(self.predictor, "single_step", None)
        if step is None:
            raise ValueError("initial_guess_policy requires a predictor exposing single_step "
                             "(ODE / neural predictors)")
        U = self.num_control_inputs
        x, us = s[:1], []
        for _ in range(self.mpc_horizon):
            u = torch.as_tensor(self.initial_guess_policy(x[0], params), dtype=torch.float32,
                                device=x.device).reshape(U)
            u = torch.clamp(u, self.action_low, self.action_high)
            us.append(u)
            x = step(x, u[None], params["dyn"])
        return torch.stack(us)

    # ---- hot path ---------------------------------------------------------
    def step(self, s: np.ndarray, time=None, params: Optional[Dict] = None) -> np.ndarray:
        """One control step: host state in, host control out."""
        if self.optimizer_logging:
            self.logging_values = {"s_logged": np.asarray(s).copy()}
        s_dev = torch.as_tensor(np.asarray(s, np.float32), device=self.device)
        if s_dev.ndim == 1:
            s_dev = s_dev[None]
        params = params if params is not None else self.default_params()
        if self._policy_seed_pending:
            # The first step after a reset seeds the warm start from the
            # policy's closed-loop rollout.
            self._policy_seed_pending = False
            self.opt_state = self._apply_policy_guess(self.opt_state,
                                                      self._policy_plan(s_dev, params))
        u, self.opt_state, diag = self._step_fn(self.opt_state, s_dev, params)
        self.u = u

        if self.optimizer_logging:
            conv = (lambda v: v) if self.logging_lazy else (
                lambda v: None if v is None else v.detach().cpu().numpy())
            for key_name, val in diag.items():
                self.logging_values[key_name] = conv(val)
            self.logging_values["u_logged"] = u.cpu().numpy()
            self.optimal_control_sequence = self.logging_values.get("u_nom")
        elif "u_nom" in diag:
            self.optimal_control_sequence = diag["u_nom"]
        # calculate_optimal_trajectory: the nominal plan's replay through the
        # predictor (and RPGD's summed stage cost), kept on the host.
        for key in ("optimal_trajectory", "summed_stage_cost"):
            if key in diag:
                setattr(self, key, diag[key].detach().cpu().numpy())

        u_host = u.cpu().numpy()
        # NaN guard at the host boundary: a diverged solve commands zero and
        # the optimizer state starts over.
        if not np.all(np.isfinite(u_host)):
            logger.warning(
                f"{self.__class__.__name__} produced non-finite control "
                f"{u_host}; substituting zeros and resetting optimizer state"
            )
            self.optimizer_reset()
            if self.predictor is not None and self.predictor.is_stateful:
                self.predictor.predictor.reset_state()  # the hidden may carry the divergence
            u_host = np.zeros_like(u_host)
            u = self.u = torch.zeros_like(u)
        self._post_step(s_dev, u)
        return u_host

    def _post_step(self, s_dev, u) -> None:
        """After the step: advance a stateful predictor's hidden with the
        applied control (the reference's predictor.update), on the device;
        a no-op for the others."""
        if self.predictor is not None:
            self.predictor.update(s_dev[:1], u.reshape(1, 1, -1))

    def default_params(self) -> Dict:
        # Scalars (an ODE's constants) and nested dyn (a learned net's
        # tensors, a recurrent net's hidden) alike become float32 tensors on
        # the device; tensors already there are passed through.
        dyn = place(self.predictor.default_params(), self.device)
        cost = self.cost_function.current_params(device=self.device)
        return {"dyn": dyn, "cost": cost["cost"], "attrs": cost["attrs"]}

    # ---- shared pure helpers ---------------------------------------------
    def _cost_params(self, params: Dict) -> Dict:
        return {"cost": params["cost"], "attrs": params["attrs"]}

    def _disagreement_fn(self):
        return getattr(getattr(self.predictor, "predictor", self.predictor), "disagreement",
                       None)

    def _post_terminal_fn(self):
        """The cost's post-terminal hook (a learned value terminal,
        ``costs/value_terminal.py``), evaluated outside the cost kernels on
        the terminal states their emit_terminal forms write; None for a
        plain cost."""
        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        return getattr(cf, "post_terminal_cost", None)

    def _value_grad_spec(self):
        """``{"n_layers": L}`` when the cost is a ValueTerminalCost whose V
        is a plain ``w*/b*`` tanh MLP and whose base has no post hook of
        its own: K7's value_spec form then evaluates V and seeds its
        adjoint with dV/dx_H.  None otherwise (a net with norms, any other
        hook): the gradient takes ``torch.autograd`` through the fused
        loop, in which the hook takes part."""
        from control_toolkit_tpu_torch.costs.value_terminal import ValueTerminalCost

        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        if not isinstance(cf, ValueTerminalCost):
            return None
        if getattr(cf.base, "post_terminal_cost", None) is not None:
            return None
        net = cf.value_params
        n = sum(1 for k in net if str(k).startswith("w"))
        if n == 0 or set(net) != {f"{c}{i}" for i in range(n) for c in "wb"}:
            return None
        return {"n_layers": n}

    def _flatten_value_ops(self, params) -> list:
        """The live value net's ``[w0, b0, ..., w_{L-1}, b_{L-1}]`` (``w_i``
        ``[in, out]``, as ``mlp_apply`` reads them) with the value scale
        folded into the last layer on every call, so a re-fit or a changed
        scale reaches K7's value_spec form with nothing rebuilt."""
        net, scale = params["cost"]["_value_net"], params["cost"]["_value_scale"]
        n = sum(1 for k in net if str(k).startswith("w"))
        ops = [t for i in range(n) for t in (net[f"w{i}"], net[f"b{i}"])]
        return ops[:-2] + [ops[-2] * scale, ops[-1] * scale]

    def _finalize_cost_kernel(self, raw_call, post):
        """``raw_call(s_tiled, Q, u_prev, params)`` returns ``cost [K]``
        (``post`` None) or ``(cost [K], x_H [K, S])`` (an emit_terminal
        form): the cost with ``post(x_H) / (H+1)`` added, V as torch
        matmuls on the emitted terminal states, under the mean over H+1."""
        if post is None:
            return raw_call
        inv = 1.0 / (self.mpc_horizon + 1)

        def cost_fn(s_tiled, Q, u_prev, params):
            cost, x_term = raw_call(s_tiled, Q, u_prev, params)
            return cost + post(x_term, self._cost_params(params)) * inv

        return cost_fn

    def _wrap_risk(self, cost_fn):
        """``cost_fn`` (``(s_tiled, Q, u_prev, params) -> [K]``) plus the
        epistemic-uncertainty penalty when risk_weight is on."""
        if not self.risk_weight or cost_fn is None:
            return cost_fn
        w, dis = self.risk_weight, self._disagreement_fn()

        def wrapped(s_tiled, Q, u_prev, params):
            return cost_fn(s_tiled, Q, u_prev, params) + w * dis(s_tiled, Q, params["dyn"])

        return wrapped

    def _robust_aggregate(self, member_costs: torch.Tensor) -> torch.Tensor:
        """``[E, K]`` member costs -> ``[K]`` per the robust_eval mode."""
        r = str(self.robust_eval)
        if r == "mean":
            return member_costs.mean(dim=0)
        if r == "worst":
            return member_costs.max(dim=0).values
        n = max(1, int(np.ceil(float(r.split(":", 1)[1]) * member_costs.shape[0])))
        return torch.topk(member_costs.T, n, dim=1).values.mean(dim=1)

    def _robust_cost_and_members(self, s_tiled, Q, u_prev, params):
        """Every plan under all E members (their mean dynamics), the member
        costs aggregated per robust_eval: ``(cost [K], trajs [E, K, H+1,
        S])``; differentiable (a subgradient through the max)."""
        pred = getattr(self.predictor, "predictor", self.predictor)
        trajs = pred.rollout_all_members(s_tiled, Q, params["dyn"])
        cp = self._cost_params(params)
        costs = torch.stack([self.cost_function.get_trajectory_cost(tr, Q, u_prev, cp)
                             for tr in trajs])
        return self._robust_aggregate(costs), trajs

    def _robust_member_cost(self):
        def cost_fn(s_tiled, Q, u_prev, params):
            return self._robust_cost_and_members(s_tiled, Q, u_prev, params)[0]

        return cost_fn

    def _rollout_and_cost(self, s_tiled, Q, u_prev, params):
        if self.robust_eval:
            cost, trajs = self._robust_cost_and_members(s_tiled, Q, u_prev, params)
            traj = trajs.mean(dim=0)  # the diagnostics' trajectory: the mean model's
        else:
            traj = self.predictor.rollout(s_tiled, Q, params["dyn"])
            cost = self.cost_function.get_trajectory_cost(
                traj, Q, u_prev, self._cost_params(params)
            )
        if self.risk_weight:
            cost = cost + self.risk_weight * self._disagreement_fn()(s_tiled, Q, params["dyn"])
        return cost, traj

    def _can_fuse_rollout(self) -> bool:
        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        return (
            self.predictor is not None
            and self.predictor.single_step is not None
            and cf is not None
            and cf.supports_fused_rollout
        )

    def _fused_cost(self, s_tiled, Q, u_prev, params):
        """Trajectory cost without materializing [K,H+1,S] (ops/rollout.py)."""
        from control_toolkit_tpu_torch.ops.rollout import scan_cost_rollout

        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        cp = self._cost_params(params)
        step = self.predictor.single_step
        cost, _ = scan_cost_rollout(
            lambda x, u, p: step(x, u, p["dyn"]),
            lambda x, u, up, p: cf.stage_cost_step(x, u, up, cp),
            lambda x, p: cf.get_terminal_cost(x, cp),
            s_tiled, Q, u_prev, params, remat=self.remat,
        )
        return cost

    def _make_cost_only(self, differentiable: bool = False):
        """Best cost-only rollout evaluator, or None: under robust_eval the
        member-robust cost; else the first kernel family of ``COST_ORDER``
        whose gate admits the model (K1 for an ODE, K11/K13 for a learned
        net, K11's member-block form for an ensemble, K14 for a sparse GP,
        K12 for a residual model; plain versions on CPU tensors) > the fused
        loop > None (callers keep the trajectory path); each with the
        risk_weight penalty; under a post-terminal hook each family's is
        its cost kernel's emit_terminal form plus the hook.  ``differentiable``
        leaves the kernels out (they have no autograd rule): the gradient
        optimizers' ``torch.autograd`` path."""
        from control_toolkit_tpu_torch.optimizers import kernel_families as kf

        if self.robust_eval:
            return self._wrap_risk(self._robust_member_cost())
        for fam in kf.COST_ORDER if not differentiable else ():
            if fam.can_use_cost(self):
                return self._wrap_risk(fam.build_cost(self))
        if self._can_fuse_rollout():
            return self._wrap_risk(self._fused_cost)
        return None

    def _make_grad_and_cost_only(self):
        """The gradient path of the AD optimizers: ``grad_fn(Q, s_tiled,
        u_prev, params) -> d(sum_k J_k)/dQ`` and the ``cost_only``
        evaluator (None when logging is on: the callers then keep the
        trajectory path for its diagnostics).

        With logging off and an eligible model the gradient is the first
        family of ``GRAD_ORDER`` whose gate admits it (K7 for an ODE, K8 for
        an MLP, K8's member-block form for an ensemble, K10 for a GP, K9 for
        a residual model; under a plain tanh-MLP value terminal, K7's
        value_spec form) and the cost ``_make_cost_only``'s; otherwise
        ``torch.autograd`` through ``_make_cost_only(differentiable=True)``
        (the fused loop, with the risk and robust terms), or through the
        trajectory rollout when logging is on."""
        from control_toolkit_tpu_torch.optimizers import kernel_families as kf

        for fam in kf.GRAD_ORDER if not self.optimizer_logging else ():
            if fam.can_use_grad(self):
                kernel = fam.build_grad(self)

                def kernel_grad(Q, s_tiled, u_prev, params):
                    return kernel(s_tiled, Q, u_prev, params)[1]

                return kernel_grad, self._make_cost_only()

        cost_only = None if self.optimizer_logging else self._make_cost_only(differentiable=True)
        eval_cost = cost_only or (lambda s, Q, up, p: self._rollout_and_cost(s, Q, up, p)[0])

        def autograd_grad(Q, s_tiled, u_prev, params):
            with torch.enable_grad():
                Qv = Q.detach().requires_grad_(True)
                (dQ,) = torch.autograd.grad(eval_cost(s_tiled, Qv, u_prev, params).sum(), Qv)
            return dQ

        return autograd_grad, cost_only

    def _grad_kernel_model_ok(self, has_per_slot_dyn: bool = False) -> bool:
        """The model half of the batched gradient fleets' gates (JAX
        ``base.py:997``): an ODE model or ``"ODE+res"`` (per-slot dynamics
        are their constants), or, without per-slot dynamics, a sparse GP or
        a float32 MLP (their parameters are shared by the sessions), each
        over a cost with adjoints.  The JAX gate's ``num_rollouts >= 128``
        for the MLP chose between two TPU paths that compute the same
        function; the port has the kernel path alone, so it has no
        counterpart, nor has the TPU tile half (``_grad_kernel_tile_ok``)."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural, ode, residual

        if ode.can_use_grad(self) or residual.can_use_grad(self):
            return True
        return not has_per_slot_dyn and (gp.can_use_grad(self) or neural.can_use_grad(self))

    def _bind_batched_grad_kernels(self, num_slots: int, per_slot_dyn=(), per_slot_cost=()):
        """The session-row gradient and cost forms and the sessions' packer
        of a B-session fleet: see kernel_families/batched.py."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import batched

        return batched.bind_batched_grad_kernels(self, num_slots, per_slot_dyn=per_slot_dyn,
                                                 per_slot_cost=per_slot_cost)

    def _soa_bindings(self, include_dyn: bool = True):
        """Bind the predictor's SOA dynamics and the cost's SOA primitives,
        plus the packed scalar parameter layout the kernels read: dynamics
        constants (``d_*`` sorted), cost weights (``c_*`` sorted),
        attributes (``a_*`` sorted), then ``__u_prev_j``.

        Returns (param_keys, pack, derivs_soa, stage_soa, terminal_soa,
        pred); ``stage_soa`` includes the control-change term and the
        MAX_COST shift.  ``include_dyn=False`` leaves the dynamics out of
        the layout (and returns ``derivs_soa=None``): the network-rollout
        kernels take a learned net's weights as tensors, not scalars.

        A residual (``"ODE+res"``) predictor's dynamics constants are its
        analytic base's: the ``d_*`` keys and ``derivs_soa`` come from
        ``pred.base``, and ``pack`` reads them from ``params["dyn"]["base"]``
        (the residual's weights go to its kernels as tensors)."""
        from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor

        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        pred = getattr(self.predictor, "predictor", self.predictor)
        U = self.num_control_inputs

        dyn_src = pred.base if isinstance(pred, ResidualPredictor) else pred
        dyn_nested = dyn_src is not pred
        dyn_keys = sorted(dyn_src.default_params()) if include_dyn else []
        cost_keys = sorted(cf.dynamic_config_keys)
        attr_keys = sorted(cf.attr_keys)
        param_keys = (
            [f"d_{k}" for k in dyn_keys]
            + [f"c_{k}" for k in cost_keys]
            + [f"a_{k}" for k in attr_keys]
            + [f"__u_prev_{j}" for j in range(U)]
        )

        def split_p(p):
            dyn = {k: p[f"d_{k}"] for k in dyn_keys}
            cp = {
                "cost": {k: p[f"c_{k}"] for k in cost_keys},
                "attrs": {k: p[f"a_{k}"] for k in attr_keys},
            }
            return dyn, cp

        max_cost = cf.MAX_COST

        def stage_soa(xs, us, prev_us, p):
            _, cp = split_p(p)
            return (
                cf._stage_cost_core_soa(xs, us, cp)
                + cf.control_change_cost_soa(us, prev_us, cp)
                - max_cost
            )

        def terminal_soa(xs, p):
            _, cp = split_p(p)
            return cf.kernel_terminal_soa(xs, cp)

        def derivs(xs, us, p):
            dyn, _ = split_p(p)
            return dyn_src.dynamics.soa(xs, us, dyn)

        attr_defaults = cf.attr_defaults
        device = self.device

        def pack(params, u_prev):
            vals = {}
            dyn_leaves = params["dyn"]["base"] if dyn_nested else params["dyn"]
            for k in dyn_keys:
                vals[f"d_{k}"] = dyn_leaves[k]
            for k in cost_keys:
                vals[f"c_{k}"] = params["cost"][k]
            for k in attr_keys:
                # A missing attribute takes the cost's declared default, so
                # the kernel path optimizes the same objective as the loop.
                v = params["attrs"].get(k, attr_defaults.get(k, 0.0))
                if np.ndim(v) != 0:
                    raise ValueError(
                        f"attribute {k!r} is array-valued; the kernel path "
                        "carries attributes as packed scalars. Set "
                        "force_scan=True or keep this attribute scalar."
                    )
                vals[f"a_{k}"] = v
            up = torch.as_tensor(u_prev, dtype=torch.float32, device=device)
            if up.ndim >= 2 and up.shape[0] > 1:
                raise ValueError(
                    "the kernel path packs u_prev as scalars and supports only "
                    f"a single shared previous control; got shape {tuple(up.shape)}"
                )
            up = up.reshape(-1)
            for j in range(U):
                vals[f"__u_prev_{j}"] = up[j]
            return torch.stack([
                torch.as_tensor(vals[k], dtype=torch.float32, device=device)
                for k in param_keys
            ])

        return param_keys, pack, derivs if include_dyn else None, stage_soa, terminal_soa, pred

    def plan_sharding(self, mesh, axis=None) -> None:
        raise _not_ported("mesh sharding")

    @property
    def optimizer_name(self) -> str:
        return self.registered_name
