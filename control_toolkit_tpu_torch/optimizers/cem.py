"""CEM — Cross-Entropy Method optimizer (counterpart of
control_toolkit_tpu/optimizers/cem.py).

Each outer iteration samples K sequences ``Q = clip(mue + z*std)`` from a
per-(h, u) diagonal Gaussian, scores them, takes the ``cem_best_k`` elites
and refits mue and std to them (the population std, ddof 0, as
``jnp.std``).  The first control step runs ``warmup_iterations`` when
``warmup`` is on.  After the iterations std is clipped to
``[cem_stdev_min, 1e8]``, mue and std shift one step (the tails take the
initial defaults), and the control is the best elite's first action.

Two scoring paths, chosen as the JAX package chooses them:

* modular: ``z`` is a ``torch.randn`` draw and K1 (``ops/cost_rollout.py``)
  scores Q through ``Optimizer._make_cost_only`` (K1, or its emit_terminal
  form under a learned value terminal; the trajectory rollout when
  logging is on);
* ``fully_fused`` (where ``_can_fully_fuse`` admits it): K5
  (``ops/fused_cem.py``) draws the population from the counter PRNG,
  rolls it out and scores it in one launch; only the elite rows are drawn
  again, in torch, for the refit (over a ``:fast`` predictor both draw the
  fast normals, ``model.fast_math``: the JAX ``fast_sampling``).

Each step is a draw per outer iteration (``sample_draws``: the normals
``[K,H,U]``, or the counter PRNG's ``seed2`` on the fused path) followed
by a deterministic ``update(state, s, params, draws)``, so tests can feed
both packages the same random numbers.  The tick counter is a host int,
so the warmup trip count is a host decision.

The batched-mpc controller's B-session step is the fused one
(``_make_batched_fused_cem_step``): one K6 launch an outer iteration
(``ops/fused_cem_cols.py``).  The modular B-session step
(``_make_batched_cem_step``, one launch of K1's session-row form an outer
iteration) is built for compositions that call it; the controller does not
route to it, as the JAX package's does not (a modular CEM fleet takes the
JAX package's vmapped per-slot step, which the port refuses).  Not ported
(``NotImplementedError``, ROADMAP): the policy warm start
(``_apply_policy_guess``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.ops.counter_prng import DEFAULT_TILE_K, draw_seed2
from control_toolkit_tpu_torch.optimizers.base import Optimizer, _not_ported
from control_toolkit_tpu_torch.utils import registry


def cem_trip_count(opt, count: int) -> int:
    """Outer iterations of this control step, shared by the CEM family:
    ``warmup_iterations`` on the first step when warmup is on."""
    return opt.warmup_iterations if opt.warmup and count == 0 else opt.cem_outer_it


def cem_base_carry(mue, std, K, H, U, S, want_Q, want_traj):
    """The loop carry of the CEM-family updates (variants add their own
    entries, e.g. iCEM's elite buffer)."""
    zeros = torch.zeros
    carry = {"mue": mue, "std": std,
             "elite0": zeros((H, U), dtype=torch.float32, device=mue.device),
             "cost": zeros((K,), dtype=torch.float32, device=mue.device)}
    if want_Q:
        carry["Q"] = zeros((K, H, U), dtype=torch.float32, device=mue.device)
    if want_traj:
        carry["traj"] = zeros((K, H + 1, S), dtype=torch.float32, device=mue.device)
    return carry


def cem_shift_distribution(mue, std, u_mid, stdev_min: float, init_stdev: float, U: int,
                           stdev_max: float = 1.0e8):
    """Control-step boundary shift shared by the CEM family: clip sigma to
    ``[stdev_min, stdev_max]`` (the gradient CEMs' reference cap is 10.0),
    shift mu and sigma one step, pad the tails with the initial defaults.
    ``mue`` and ``std`` are ``[n, H, U]``: one session (n = 1) or B."""
    n = mue.shape[0]
    std = torch.clamp(std, stdev_min, stdev_max)
    std = torch.cat([std[:, 1:, :], torch.full((n, 1, U), init_stdev, dtype=torch.float32,
                                               device=std.device)], dim=1)
    mue = torch.cat([mue[:, 1:, :], u_mid.reshape(1, 1, U).to(torch.float32).expand(n, 1, U)],
                    dim=1)
    return mue, std


def cem_diag(carry, want_Q, want_traj):
    """The logging-contract diagnostics shared by the CEM family."""
    diag = {"J_logged": carry["cost"], "u_nom": carry["elite0"][None]}
    if want_Q:
        diag["Q_logged"] = carry["Q"]
    if want_traj:
        diag["rollout_trajectories_logged"] = carry["traj"]
    return diag


def refit(elite_Q: torch.Tensor):
    """Mean and population std (ddof 0) of the elites, ``[1, H, U]`` each."""
    return (torch.mean(elite_Q, dim=0, keepdim=True),
            torch.std(elite_Q, dim=0, correction=0, keepdim=True))


class CEMState(NamedTuple):
    generator: torch.Generator
    dist_mue: torch.Tensor  # [1, H, U]
    stdev: torch.Tensor     # [1, H, U]
    count: int              # host control-step counter
    u_prev: torch.Tensor    # [U]


@registry.optimizers.register("cem-tf")
@registry.optimizers.register("cem")
class CEMOptimizer(Optimizer):
    # K5's tile: part of the fused path's function (which counter a rollout
    # reads), and the divisor of K that the fused gate asks for.
    fused_tile_k = DEFAULT_TILE_K

    def __init__(
        self,
        *,
        cem_outer_it: int = 3,
        cem_initial_action_stdev: float = 0.5,
        cem_stdev_min: float = 0.01,
        cem_best_k: int = 40,
        warmup: bool = False,
        warmup_iterations: int = 250,
        fully_fused: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.cem_outer_it = int(cem_outer_it)
        self.cem_initial_action_stdev = float(cem_initial_action_stdev)
        self.cem_stdev_min = float(cem_stdev_min)
        self.cem_best_k = int(cem_best_k)
        if self.cem_best_k > self.num_rollouts:
            raise ValueError(
                f"cem_best_k={self.cem_best_k} exceeds num_rollouts={self.num_rollouts}"
            )
        self.warmup = bool(warmup)
        self.warmup_iterations = int(warmup_iterations)
        self.fully_fused = bool(fully_fused)

    def _init_state(self, generator):
        H, U = self.mpc_horizon, self.num_control_inputs
        u_mid = 0.5 * (self.action_low + self.action_high)
        return CEMState(
            generator=generator,
            dist_mue=u_mid.expand(1, H, U).to(torch.float32).clone(),
            stdev=torch.full((1, H, U), self.cem_initial_action_stdev, dtype=torch.float32,
                             device=self.device),
            count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def _apply_policy_guess(self, state, plan):
        raise _not_ported("initial_guess_policy")

    def sample_slot_normals(self, generators, mask) -> torch.Tensor:
        """The modular batched step's draws ``[cem_outer_it, B, K, H, U]``:
        each active slot's normals, iteration by iteration from its own
        generator (the single-session ``sample_draws``' order), zeros for a
        frozen slot (it draws nothing)."""
        shape = (self.num_rollouts, self.mpc_horizon, self.num_control_inputs)
        zeros = torch.zeros((self.cem_outer_it,) + shape, dtype=torch.float32,
                            device=self.device)
        return torch.stack([
            torch.stack([torch.randn(shape, generator=g, dtype=torch.float32, device=self.device)
                         for _ in range(self.cem_outer_it)]) if on else zeros
            for g, on in zip(generators, mask)
        ], dim=1)

    def _make_batched_cem_step(self, num_slots: int, per_slot_dyn=()):
        """B-session modular CEM step (JAX ``cem.py:188-330``): each outer
        iteration scores every session's population ``clip(mue + z*std)``
        in one launch of K1's session-row form
        (``ops/cost_rollout.py:cost_rollout_cols``), then takes each
        session's ``cem_best_k`` elites and refits its distribution; after
        the iterations each distribution shifts.  ``per_slot_dyn``
        constants reach K1 through the sessions' rows.

        Returns ``(step, refit_from_Q)``: ``step(states, s [B,1,S], dyn,
        cost, attrs, mask [B], draws=None) -> (u [B,U], states', costs
        [B,K])`` over the stacked state, its normals ``draws [its, B, K, H,
        U]`` drawn by ``sample_slot_normals`` unless given (the tests feed
        the JAX draws); ``refit_from_Q(states, s, dyn, cost, attrs, Q_b
        [B,K,H,U]) -> (mue [B,1,H,U], std, elite0 [B,H,U], costs [B,K])``
        the deterministic evaluate-and-refit of a given population.
        Requires ``warmup=False`` and no learned value terminal, as in JAX."""
        from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout_cols
        from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        if self.warmup:
            raise NotImplementedError(
                "batched CEM kernel path requires warmup=False (shared outer-loop trip count); "
                "warmup sessions take the vmapped scan path")
        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        if cf.post_terminal_cost is not None:
            raise NotImplementedError(
                "batched CEM steps do not evaluate a learned value terminal; use the vmapped "
                "path for valued CEM sessions")
        if not ode.compatible_model(self):
            raise ValueError("batched CEM covers the ODE models of the device plants")
        B, K = int(num_slots), self.num_rollouts
        H, U = self.mpc_horizon, self.num_control_inputs
        model, _ = ode.rollout_model(self)
        kernels.require("K1's session-row form", model.plant)
        _, slot_keys = split_slot_keys(model.param_keys, per_slot_dyn)
        pack = make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, B, self.device)
        low, high, best_k = self.action_low, self.action_high, self.cem_best_k
        u_mid = 0.5 * (low + high)

        def evaluate_and_refit(s0, Q_b, pvec_b):
            costs = cost_rollout_cols(model, s0, Q_b.reshape(B * K, H, U), pvec_b)
            idx = elite_indices(costs, best_k)
            elite = torch.take_along_dim(Q_b, idx[:, :, None, None], dim=1)  # [B, best_k, H, U]
            return (torch.mean(elite, dim=1, keepdim=True),
                    torch.std(elite, dim=1, correction=0, keepdim=True), elite[:, 0], costs)

        def refit_from_Q(states, s, dyn, cost, attrs, Q_b):
            return evaluate_and_refit(s[:, 0, :].repeat_interleave(K, dim=0), Q_b,
                                      pack(states.u_prev, dyn, cost, attrs))

        def step(states, s, dyn, cost, attrs, mask, draws=None):
            if draws is None:
                draws = self.sample_slot_normals(states.generator, mask)
            if len(draws) != self.cem_outer_it:
                raise ValueError(f"{len(draws)} draws for {self.cem_outer_it} outer iterations")
            pvec_b = pack(states.u_prev, dyn, cost, attrs)
            s0 = s[:, 0, :].repeat_interleave(K, dim=0)
            mue, std = states.dist_mue, states.stdev                          # [B, 1, H, U]
            for z in draws:
                Q_b = torch.clamp(mue + z * std, low, high)
                mue, std, elite0, costs = evaluate_and_refit(s0, Q_b, pvec_b)
            u = elite0[:, 0, :]
            mue, std = cem_shift_distribution(mue[:, 0], std[:, 0], u_mid, self.cem_stdev_min,
                                              self.cem_initial_action_stdev, U)
            new = CEMState(generator=states.generator, dist_mue=mue[:, None], stdev=std[:, None],
                           count=states.count + 1, u_prev=u)
            return u, new, costs

        return step, refit_from_Q

    def sample_slot_seeds(self, generators, mask) -> torch.Tensor:
        """The batched fused step's draw, K6's seeds ``[cem_outer_it, B]``
        (int32, on the device): one ``randint`` of ``cem_outer_it`` seeds
        from each active slot's generator, zeros for a frozen slot (it
        draws nothing)."""
        its = self.cem_outer_it
        zeros = torch.zeros(its, dtype=torch.int32, device=self.device)
        return torch.stack([
            torch.randint(0, 2**31 - 1, (its,), generator=g, dtype=torch.int32,
                          device=self.device) if on else zeros
            for g, on in zip(generators, mask)
        ], dim=1)

    def _make_batched_fused_cem_step(self, num_slots: int, per_slot_dyn=()):
        """B-session fully-fused CEM step for the batched-mpc controller
        (JAX ``cem.py:332-480``): each outer iteration scores every
        session's population in one K6 launch (``ops/fused_cem_cols.py``),
        takes each session's ``cem_best_k`` elites with one ``torch.topk``
        over ``[B, K]``, draws their rows again with ``regen_cols`` (one set
        of launches whatever B is) and refits; then each session's
        distribution shifts.  ``per_slot_dyn`` constants reach K6 through
        the sessions' ``pvec_b`` rows.

        Returns ``(step, update)``: ``step(states, s [B,1,S], dyn, cost,
        attrs, mask [B]) -> (u [B,U], states', costs [B,K])`` over the
        stacked state (``generator`` a tuple of the slots' generators,
        ``dist_mue``/``stdev [B,1,H,U]``, ``count`` a numpy ``[B]``,
        ``u_prev [B,U]``); ``update(states, s, dyn, cost, attrs, seeds
        [its, B] int32)`` is the deterministic part, for tests that feed
        the JAX seeds.  Each active slot draws its ``cem_outer_it`` seeds
        on the device from its own generator; a frozen one (``mask``
        false) draws nothing, so a session's draws depend neither on B nor
        on the other slots' masks."""
        from control_toolkit_tpu_torch.ops.counter_prng import ROWS
        from control_toolkit_tpu_torch.ops.fused_cem_cols import fused_cem_cols, regen_cols
        from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        if self.warmup:
            raise NotImplementedError(
                "batched fused CEM requires warmup=False (shared outer-loop trip count)")
        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        if cf.post_terminal_cost is not None:
            raise NotImplementedError(
                "batched fused CEM does not evaluate a learned value terminal")
        if not ode.compatible_model(self):
            raise ValueError("batched fused CEM covers the ODE models of the device plants")
        B, K = int(num_slots), self.num_rollouts
        U, its = self.num_control_inputs, self.cem_outer_it
        if K % ROWS:
            raise ValueError(f"batched fused CEM needs K % {ROWS} == 0; got K={K}")
        model, _ = ode.rollout_model(self)
        kernels.require("K6", model.plant)
        _, slot_keys = split_slot_keys(model.param_keys, per_slot_dyn)
        pack = make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, B, self.device)
        low, high, best_k = self.action_low, self.action_high, self.cem_best_k
        u_mid = 0.5 * (low + high)

        def update(states, s, dyn, cost, attrs, seeds):
            if len(seeds) != its:
                raise ValueError(f"{len(seeds)} seed rows for {its} outer iterations")
            pvec_b = pack(states.u_prev, dyn, cost, attrs)
            s0 = s[:, 0, :].contiguous()
            mue, std = states.dist_mue[:, 0], states.stdev[:, 0]           # [B, H, U]
            for seed_b in seeds:
                costs = fused_cem_cols(model, s0, mue, std, pvec_b, seed_b, low, high, K)
                elite = regen_cols(seed_b, elite_indices(costs, best_k), mue, std, low, high, K,
                                   fast=model.fast_math)
                mue = torch.mean(elite, dim=1)
                std = torch.std(elite, dim=1, correction=0)
                elite0 = elite[:, 0]
            u = elite0[:, 0, :]
            mue, std = cem_shift_distribution(mue, std, u_mid, self.cem_stdev_min,
                                              self.cem_initial_action_stdev, U)
            new = CEMState(generator=states.generator, dist_mue=mue[:, None], stdev=std[:, None],
                           count=states.count + 1, u_prev=u)
            return u, new, costs

        def step(states, s, dyn, cost, attrs, mask):
            return update(states, s, dyn, cost, attrs,
                          self.sample_slot_seeds(states.generator, mask))

        return step, update

    def _can_fully_fuse(self) -> bool:
        """K5 scores the population: the option is on, logging is off (the
        kernel writes costs only), the model and cost are K1's (``ode``
        family), no post-terminal hook (K5 writes no terminal states: a
        learned value terminal takes the modular path over K1's
        emit_terminal form, JAX ``cem.py:162``) and K divides into K5's
        tiles."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        return (self.fully_fused and not self.optimizer_logging and ode.can_use_cost(self)
                and self._post_terminal_fn() is None
                and self.num_rollouts % self.fused_tile_k == 0)

    # ---- sampling -----------------------------------------------------------
    def _draw(self, generator: torch.Generator):
        """One outer iteration's draw: K5's ``seed2 = [seed, 0]`` (int32 on
        the device) or the normals ``[K, H, U]``."""
        if self._fused:
            return draw_seed2(generator, self.device)
        return torch.randn((self.num_rollouts, self.mpc_horizon, self.num_control_inputs),
                           generator=generator, dtype=torch.float32, device=self.device)

    def sample_draws(self, state: CEMState) -> list:
        """This step's draws, one per outer iteration."""
        return [self._draw(state.generator) for _ in range(cem_trip_count(self, state.count))]

    # ---- the step -----------------------------------------------------------
    def _make_step_fn(self):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        low, high = self.action_low, self.action_high
        best_k = self.cem_best_k
        u_mid = 0.5 * (low + high)
        self._fused = self._can_fully_fuse()
        cost_only = None if self.optimizer_logging else self._make_cost_only()
        # Logging keeps the population and its trajectories; the fused gate
        # requires logging off.
        want_Q = want_traj = self.optimizer_logging
        if self._fused:
            from control_toolkit_tpu_torch.ops.fused_cem import fused_cem_costs, regen_controls
            from control_toolkit_tpu_torch.optimizers.kernel_families import ode

            model, pack = ode.rollout_model(self)
            kernels.require("K5", model.plant)
            tile = self.fused_tile_k

        def prepare(s, params, u_prev):
            """``score(mue, std, draw) -> (cost [K], pick, logged)`` at state
            ``s``: ``pick(idx)`` gives the controls of rollouts ``idx``,
            ``logged`` the population and trajectories logging keeps."""
            if self._fused:
                s0, pvec = s[0], pack(params, u_prev)

                def score(mue, std, seed2):
                    cost = fused_cem_costs(model, s0, mue[0], std[0], pvec, seed2, low, high, K,
                                           tile)
                    return cost, (lambda idx: regen_controls(seed2, idx, mue[0], std[0], low,
                                                             high, K, tile, fast=model.fast_math)), {}
                return score

            s_tiled = s[:1].expand(K, -1).contiguous()

            def score(mue, std, z):
                Q = torch.clamp(mue + z * std, low, high)
                logged = {"Q": Q} if want_Q else {}
                if cost_only is not None:
                    cost = cost_only(s_tiled, Q, u_prev, params)
                else:
                    cost, logged["traj"] = self._rollout_and_cost(s_tiled, Q, u_prev, params)
                return cost, (lambda idx: Q[idx]), logged
            return score

        def update(state: CEMState, s, params, draws):
            if len(draws) != cem_trip_count(self, state.count):
                raise ValueError(f"step {state.count}: {len(draws)} draws for "
                                 f"{cem_trip_count(self, state.count)} outer iterations")
            score = prepare(s, params, state.u_prev)
            carry = cem_base_carry(state.dist_mue, state.stdev, K, H, U, self.num_states,
                                   want_Q, want_traj)
            for draw in draws:
                cost, pick, logged = score(carry["mue"], carry["std"], draw)
                elite_Q = pick(elite_indices(cost, best_k))
                mue, std = refit(elite_Q)
                carry.update(mue=mue, std=std, elite0=elite_Q[0], cost=cost, **logged)
            u = carry["elite0"][0, :]
            mue, std = cem_shift_distribution(carry["mue"], carry["std"], u_mid,
                                              self.cem_stdev_min, self.cem_initial_action_stdev, U)
            new_state = CEMState(generator=state.generator, dist_mue=mue, stdev=std,
                                 count=state.count + 1, u_prev=u)
            return u, new_state, cem_diag(carry, want_Q, want_traj)

        self.prepare = prepare
        self.update = update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
