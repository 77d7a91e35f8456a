"""RPGD — Resampling Parallel Gradient Descent (Heetmeyer et al., ICRA 2023;
counterpart of control_toolkit_tpu/optimizers/rpgd.py).

A persistent population of K control sequences is optimized with batched
Adam through the rollout, ``outer_its`` steps per tick (``warmup_iterations``
on the first tick when ``warmup`` is on), each rollout's gradient clipped
to norm ``gradmax_clip``.  Then K1 scores the population, the best
sequence gives the control, and the population shifts by
``shift_previous`` steps with the tail repeated.  Every ``resamp_per``
ticks the ``opt_keep_k`` elites stay and the rest are resampled, with the
Adam moment surgery of rpgd_resample_surgery; otherwise every row's
moments shift.  Gradients come from K7 through
``Optimizer._make_grad_and_cost_only``.

Each tick is a draw (``sample_resample``, taken only on a resample tick)
followed by a deterministic ``update(state, s, params, draw)``, so tests
can feed both packages the same random numbers.  The tick counter and
Adam's step are host ints, so the resample tick and the warmup trip
count are host decisions and a step reads nothing back from the device.

The batched-mpc controller's B-session step (``_make_batched_rpgd_step``)
takes every session's gradients in one launch of a gradient kernel's
session-row form an Adam iteration and scores them in one of its cost
kernel's (``kernel_families/batched.py``).

Not ported (``NotImplementedError``, ROADMAP): the policy warm start
(``_apply_policy_guess``) and ``calculate_optimal_trajectory``.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.ops.common import (
    AdamState, adam_descent, adam_init, elite_indices, shift_rows,
)
from control_toolkit_tpu_torch.ops.interpolation import Interpolator
from control_toolkit_tpu_torch.optimizers.base import Optimizer, _not_ported
from control_toolkit_tpu_torch.utils import registry

logger = logging.getLogger(__name__)


class RPGDState(NamedTuple):
    generator: torch.Generator
    Q: torch.Tensor                # [K, H, U]
    adam: AdamState                # over [K, H, U]
    trajectory_ages: torch.Tensor  # [K] float32
    count: int                     # host tick counter
    u_prev: torch.Tensor           # [U]


def rpgd_resample_surgery(Qn, m, v, ages, best_idx, Qres):
    """Resample tick: fresh sequences replace the non-elites ([Qres,
    Q_keep] order), the elites' moments are gathered and shifted left with
    zero tails, fresh rows get zero moments and age zero.  Over one
    session's ``[K, H, U]`` or, with a leading session axis on every
    operand, a fleet's."""
    keep = best_idx[..., None, None]

    def gather(M):
        return torch.take_along_dim(M, keep, dim=-3)

    zeros_rows = torch.zeros(Qres.shape, dtype=m.dtype, device=m.device)
    Q_new = torch.cat([Qres, gather(Qn)], dim=-3)
    ages_new = torch.cat([torch.zeros(Qres.shape[:-2], dtype=ages.dtype, device=ages.device),
                          torch.take_along_dim(ages, best_idx, dim=-1)], dim=-1)
    m_new = torch.cat([zeros_rows, shift_rows(gather(m))], dim=-3)
    v_new = torch.cat([zeros_rows, shift_rows(gather(v))], dim=-3)
    return Q_new, m_new, v_new, ages_new


def rpgd_keep_surgery(m, v):
    """Non-resample tick: shift every moment row left."""
    return shift_rows(m), shift_rows(v)


def spread_penalty_grad(Q: torch.Tensor, alpha: float) -> torch.Tensor:
    """The gradient of the max-entropy penalty ``-alpha/2 * sum_{h,u}
    log(var_k Q[k,h,u] + 1e-8)`` of one population ``[K,H,U]``, or of each
    session's in a fleet's ``[B,K,H,U]`` (the population variance, as
    ``jnp.var``)."""
    with torch.enable_grad():
        Qv = Q.detach().requires_grad_(True)
        pen = -0.5 * alpha * torch.sum(torch.log(torch.var(Qv, dim=-3, correction=0) + 1e-8))
        (g,) = torch.autograd.grad(pen, Qv)
    return g


def stack_draws(draws: list):
    """Slots' resample draws stacked on a new leading axis (a particle
    draw's parts each)."""
    if isinstance(draws[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*draws))
    return torch.stack(draws)


@registry.optimizers.register("rpgd-tf")
@registry.optimizers.register("rpgd")
@registry.optimizers.register("dist-adam-resamp2-tf")
class RPGDOptimizer(Optimizer):
    def __init__(
        self,
        *,
        outer_its: int = 2,
        sample_stdev: float = 0.5,
        sample_mean: float = 0.0,
        sample_whole_control_space: bool = True,
        uniform_dist_min: float = -1.0,
        uniform_dist_max: float = 1.0,
        resamp_per: int = 10,
        period_interpolation_inducing_points: int = 10,
        SAMPLING_DISTRIBUTION: str = "uniform",
        shift_previous: int = 1,
        warmup: bool = False,
        warmup_iterations: int = 250,
        learning_rate: float = 0.05,
        opt_keep_k_ratio: float = 0.25,
        gradmax_clip: float = 5.0,
        rtol: float = 1e-3,
        adam_beta_1: float = 0.9,
        adam_beta_2: float = 0.999,
        adam_epsilon: float = 1e-8,
        maximum_entropy_alpha: float = 0.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if self.calculate_optimal_trajectory:
            raise _not_ported("calculate_optimal_trajectory")
        # Max-entropy population bonus: the gradient objective becomes
        # sum_k J_k - alpha/2 * sum_{h,u} log(var_k Q[:,h,u] + 1e-8) (the eps
        # inside the log keeps the gradient finite at zero spread).
        self.maximum_entropy_alpha = float(maximum_entropy_alpha)
        self.outer_its = int(outer_its)
        self.sample_stdev = float(sample_stdev)
        self.sample_mean = float(sample_mean)
        self.sample_whole_control_space = bool(sample_whole_control_space)
        self.uniform_dist_min = float(uniform_dist_min)
        self.uniform_dist_max = float(uniform_dist_max)
        self.resamp_per = int(resamp_per)
        self.period_interpolation_inducing_points = int(period_interpolation_inducing_points)
        self.sampling_distribution = str(SAMPLING_DISTRIBUTION)
        if self.sampling_distribution not in ("uniform", "normal"):
            raise ValueError(f"RPGD cannot interpret sampling type {SAMPLING_DISTRIBUTION!r}")
        self.shift_previous = int(shift_previous)
        self.warmup = bool(warmup)
        self.warmup_iterations = int(warmup_iterations)
        self.learning_rate = float(learning_rate)
        self.opt_keep_k = max(int(self.num_rollouts * float(opt_keep_k_ratio)), 1)
        self.gradmax_clip = float(gradmax_clip)
        self.rtol = float(rtol)
        if self.rtol != 1e-3:
            logger.warning(
                "rtol is accepted for reference-config parity but the "
                "fixed-trip-count Adam loop does not early-stop; tuning "
                "it has no effect"
            )
        self.adam_beta_1 = float(adam_beta_1)
        self.adam_beta_2 = float(adam_beta_2)
        self.adam_epsilon = float(adam_epsilon)

    def configure(self, num_states, num_control_inputs, dt=None, **kwargs):
        self.interp = Interpolator.build(
            self.mpc_horizon, self.period_interpolation_inducing_points, self.device
        )
        super().configure(num_states, num_control_inputs, dt=dt, **kwargs)

    # ---- sampling -----------------------------------------------------------
    def _draw_actions(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """The random controls at the P inducing points, ``[batch, P, U]``."""
        shape = (batch, self.interp.number_of_interpolation_inducing_points,
                 self.num_control_inputs)
        if self.sampling_distribution == "normal":
            z = torch.randn(shape, generator=generator, dtype=torch.float32, device=self.device)
            return self.sample_mean + self.sample_stdev * z
        if self.sample_whole_control_space:
            lo, hi = self.action_low, self.action_high
        else:
            lo, hi = self.uniform_dist_min, self.uniform_dist_max
        r = torch.rand(shape, generator=generator, dtype=torch.float32, device=self.device)
        return lo + (hi - lo) * r

    def _actions_from_draw(self, Qp: torch.Tensor) -> torch.Tensor:
        """Clip the inducing-point draw and interpolate it to ``[batch, H, U]``."""
        return self.interp.interpolate(torch.clamp(Qp, self.action_low, self.action_high))

    def _draw_resample(self, generator: torch.Generator, n: int):
        """The random numbers a resample tick consumes: base RPGD draws the
        fresh sequences from the sampling distribution."""
        return self._draw_actions(generator, n)

    def _resample(self, draw, Q, cost, n: int) -> torch.Tensor:
        """The ``n`` fresh sequences of a resample tick, from its draw (of
        one session, or stacked over sessions with ``Q [B,K,H,U]`` and
        ``cost [B,K]``)."""
        del Q, cost, n
        return self._actions_from_draw(draw)

    def sample_resample(self, state: RPGDState):
        """This tick's draw: None unless it is a resample tick."""
        if state.count % self.resamp_per != 0:
            return None
        return self._draw_resample(state.generator, self.num_rollouts - self.opt_keep_k)

    def _init_state(self, generator):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        return RPGDState(
            generator=generator,
            Q=self._actions_from_draw(self._draw_actions(generator, K)),
            adam=adam_init((K, H, U), self.device),
            trajectory_ages=torch.zeros(K, dtype=torch.float32, device=self.device),
            count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def _apply_policy_guess(self, state, plan):
        raise _not_ported("initial_guess_policy")

    def sample_slot_resample(self, states: RPGDState, mask) -> list:
        """The batched step's draws, one a slot: slot b's resample draw
        where it is active (``mask``) on its resample tick, else None (a
        frozen slot draws nothing)."""
        n = self.num_rollouts - self.opt_keep_k
        return [self._draw_resample(g, n) if on and count % self.resamp_per == 0 else None
                for g, count, on in zip(states.generator, states.count, mask)]

    def _make_batched_rpgd_step(self, num_slots: int, per_slot_dyn=()):
        """B-session RPGD step for the batched-mpc controller (JAX
        ``rpgd.py:214-336``): each Adam iteration takes every session's
        gradients in one launch of the gradient kernel's session-row form,
        and the final scoring is one launch of its cost kernel's
        (``_bind_batched_grad_kernels``: K7/K1 over an ODE, K8/K11 over an
        MLP, K9/K12 over ``"ODE+res"``, K10/K14 over a GP; with a learned
        value terminal, their value_spec and emit_terminal forms).  The Adam update
        (per-session counters), the per-rollout clip, the entropy bonus's
        gradient, each session's elites, the shift, each resampling slot's
        ``_resample`` (``rpgd-particle``'s pick included) and the moment
        surgery run as torch ops on the stacked ``[B, K, H, U]`` state, the
        surgery a per-session choice on each slot's own resample tick.

        Returns ``(step, update)``: ``step(states, s [B,1,S], dyn, cost,
        attrs, mask [B]) -> (u [B,U], states', costs [B,K])`` over the
        stacked state (``generator`` a tuple of the slots' generators,
        ``count`` and ``adam.step`` numpy ``[B]``), each active slot on its
        resample tick drawing from its own generator
        (``sample_slot_resample``); ``update(states, s, dyn, cost, attrs,
        draws)`` is the deterministic part, ``draws`` one entry a slot (its
        draw, or None), for tests that feed the JAX draws.  A slot on its
        resample tick without a draw is a frozen one: it keeps its
        population's rows, and the caller discards its result.  Requires
        ``warmup=False`` (one Adam trip count for all sessions)."""
        if self.warmup:
            raise NotImplementedError(
                "batched RPGD kernel path requires warmup=False (shared Adam-loop trip "
                "count); warmup sessions take the vmapped scan path")
        B, K = int(num_slots), self.num_rollouts
        H, U = self.mpc_horizon, self.num_control_inputs
        gcall, ccall, pack = self._bind_batched_grad_kernels(B, per_slot_dyn=per_slot_dyn)
        low, high = self.action_low, self.action_high
        keep_k, shift = self.opt_keep_k, self.shift_previous
        lr, b1, b2, eps = self.learning_rate, self.adam_beta_1, self.adam_beta_2, self.adam_epsilon
        gclip, alpha = self.gradmax_clip, self.maximum_entropy_alpha

        def update(states: RPGDState, s, dyn, cost, attrs, draws):
            pvec_b = pack(states.u_prev, dyn, cost, attrs)
            s0 = s[:, 0, :].repeat_interleave(K, dim=0)                      # [B*K, S]

            def grad(Q):
                dQ = gcall(s0, Q.reshape(B * K, H, U), pvec_b, dyn, cost)[1]
                dQ = dQ.reshape(B, K, H, U)
                return dQ + spread_penalty_grad(Q, alpha) if alpha > 0.0 else dQ

            Q, adam = adam_descent(states.Q, states.adam, grad, self.outer_its, lr, b1, b2, eps,
                                   gclip, low, high)
            costs = ccall(s0, Q.reshape(B * K, H, U), pvec_b, dyn, cost)       # [B, K]
            best_idx = elite_indices(costs, keep_k)                            # [B, keep_k]
            u = torch.take_along_dim(Q, best_idx[:, :1, None, None], dim=1)[:, 0, 0, :]
            Qn = torch.cat([Q[:, :, shift:, :], Q[:, :, -1:, :].expand(B, K, shift, U)], dim=2)
            m, v = rpgd_keep_surgery(adam.m, adam.v)
            ages = states.trajectory_ages
            slots = [b for b, d in enumerate(draws) if d is not None]
            wrong = [b for b in slots if states.count[b] % self.resamp_per != 0]
            if wrong:
                raise ValueError(f"slots {wrong}: a draw off their resample tick (every "
                                 f"{self.resamp_per})")
            if slots:
                sel = torch.as_tensor(slots, device=Q.device)
                Qres = self._resample(stack_draws([draws[b] for b in slots]), Qn[sel],
                                      costs[sel], K - keep_k)
                Q_r, m_r, v_r, ages_r = rpgd_resample_surgery(
                    Qn[sel], adam.m[sel], adam.v[sel], ages[sel], best_idx[sel], Qres)
                Qn, m, v = Qn.index_copy(0, sel, Q_r), m.index_copy(0, sel, m_r), \
                    v.index_copy(0, sel, v_r)
                ages = ages.index_copy(0, sel, ages_r)
            new_state = RPGDState(
                generator=states.generator, Q=Qn, adam=AdamState(adam.step, m, v),
                trajectory_ages=ages + 1.0, count=states.count + 1, u_prev=u,
            )
            return u, new_state, costs

        def step(states, s, dyn, cost, attrs, mask):
            return update(states, s, dyn, cost, attrs, self.sample_slot_resample(states, mask))

        return step, update

    # ---- the step -----------------------------------------------------------
    def _make_step_fn(self):
        K, U = self.num_rollouts, self.num_control_inputs
        low, high = self.action_low, self.action_high
        keep_k, shift = self.opt_keep_k, self.shift_previous
        lr, b1, b2, eps = self.learning_rate, self.adam_beta_1, self.adam_beta_2, self.adam_epsilon
        gclip = self.gradmax_clip
        alpha = self.maximum_entropy_alpha
        base_grad, cost_only = self._make_grad_and_cost_only()

        def grad_fn(Q, s_tiled, u_prev, params):
            dQ = base_grad(Q, s_tiled, u_prev, params)
            return dQ + spread_penalty_grad(Q, alpha) if alpha > 0.0 else dQ

        def update(state: RPGDState, s, params, draw=None):
            resample = state.count % self.resamp_per == 0
            if resample != (draw is not None):
                raise ValueError(f"tick {state.count}: a draw must be given exactly on "
                                 f"resample ticks (every {self.resamp_per})")
            s_tiled = s[:1].expand(K, -1).contiguous()
            iterations = self.warmup_iterations if self.warmup and state.count == 0 \
                else self.outer_its
            Q, adam = adam_descent(state.Q, state.adam,
                                   lambda Q: grad_fn(Q, s_tiled, state.u_prev, params),
                                   iterations, lr, b1, b2, eps, gclip, low, high)
            if cost_only is not None:
                cost, traj = cost_only(s_tiled, Q, state.u_prev, params), None
            else:
                cost, traj = self._rollout_and_cost(s_tiled, Q, state.u_prev, params)
            best_idx = elite_indices(cost, keep_k)
            u_nom = Q.index_select(0, best_idx[:1])              # [1, H, U]
            u = u_nom[0, 0, :]
            Qn = torch.cat([Q[:, shift:, :], Q[:, -1:, :].expand(K, shift, U)], dim=1)
            if resample:
                Qres = self._resample(draw, Qn, cost, K - keep_k)
                Q_next, m, v, ages = rpgd_resample_surgery(
                    Qn, adam.m, adam.v, state.trajectory_ages, best_idx, Qres)
            else:
                m, v = rpgd_keep_surgery(adam.m, adam.v)
                Q_next, ages = Qn, state.trajectory_ages
            diag = {"Q_logged": Q, "J_logged": cost,
                    "trajectory_ages_logged": state.trajectory_ages, "u_nom": u_nom}
            if traj is not None:
                diag["rollout_trajectories_logged"] = traj
            new_state = RPGDState(
                generator=state.generator, Q=Q_next, adam=AdamState(adam.step, m, v),
                trajectory_ages=ages + 1.0, count=state.count + 1, u_prev=u,
            )
            return u, new_state, diag

        self.update = update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_resample(state))

        return step_fn


@registry.optimizers.register("rpgd-me-tf")
@registry.optimizers.register("rpgd-me-param-tf")
class RPGDMaxEntropyOptimizer(RPGDOptimizer):
    """rpgd-me / rpgd-me-param: RPGD whose gradient objective carries the
    ``maximum_entropy_alpha`` population-spread bonus; the config supplies
    the variant's defaults."""


@registry.optimizers.register("rpgd-ml-tf")
class RPGDMLOptimizer(RPGDOptimizer):
    """rpgd-ml: rpgd-me with the reference template's nonzero
    ``maximum_entropy_alpha`` default (0.1), which the config supplies."""


@registry.optimizers.register("rpgd-particle-tf")
class RPGDParticleOptimizer(RPGDOptimizer):
    """rpgd-particle: the non-elite replacements are resampled from the
    current population with weights ``softmax(-(J - min J) /
    particle_temperature)`` and jittered with ``sample_stdev`` Gaussian
    noise at the inducing points; the elites and the moment surgery stay
    RPGD's.

    The draw is ``(uniforms [n], jitter [n, P, U])``.  The weights depend
    on this tick's costs, so the update picks the population indices from
    the uniforms by inverse CDF (``pick``): a categorical draw with
    replacement, as ``jax.random.categorical`` makes by another route."""

    def __init__(self, *, particle_temperature: float = 1.0, **kwargs):
        kwargs.setdefault("SAMPLING_DISTRIBUTION", "uniform")
        super().__init__(**kwargs)
        self.particle_temperature = float(particle_temperature)

    def _draw_resample(self, generator: torch.Generator, n: int):
        uniforms = torch.rand(n, generator=generator, dtype=torch.float32, device=self.device)
        jitter = self.sample_stdev * torch.randn(
            (n, self.interp.number_of_interpolation_inducing_points, self.num_control_inputs),
            generator=generator, dtype=torch.float32, device=self.device)
        return uniforms, jitter

    def pick(self, cost: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
        """The population index of each uniform in [0, 1): the first whose
        cumulative weight exceeds it (over the last axis: one session's
        ``cost [K]`` and ``uniforms [n]``, or each session's)."""
        low = torch.amin(cost, dim=-1, keepdim=True)
        weights = torch.softmax(-(cost - low) / self.particle_temperature, dim=-1)
        cdf = torch.cumsum(weights, dim=-1)
        idx = torch.searchsorted(cdf, uniforms * cdf[..., -1:], right=True)
        return torch.clamp(idx, max=cost.shape[-1] - 1)

    def _resample(self, draw, Q, cost, n: int) -> torch.Tensor:
        uniforms, jitter = draw
        picked = torch.take_along_dim(Q, self.pick(cost, uniforms)[..., None, None], dim=-3)
        resampled = picked + self.interp.interpolate(jitter)
        return torch.clamp(resampled, self.action_low, self.action_high)
