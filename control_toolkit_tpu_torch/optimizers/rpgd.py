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

Not ported (``NotImplementedError``, ROADMAP): the batched-session step
(``_make_batched_rpgd_step``), the policy warm start
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
    zero tails, fresh rows get zero moments and age zero."""
    K, H, U = Qn.shape
    n_res = Qres.shape[0]
    Q_new = torch.cat([Qres, Qn[best_idx]], dim=0)
    ages_new = torch.cat([torch.zeros(n_res, dtype=ages.dtype, device=ages.device),
                          ages[best_idx]], dim=0)
    zeros_rows = torch.zeros((n_res, H, U), dtype=m.dtype, device=m.device)
    m_new = torch.cat([zeros_rows, shift_rows(m[best_idx])], dim=0)
    v_new = torch.cat([zeros_rows, shift_rows(v[best_idx])], dim=0)
    return Q_new, m_new, v_new, ages_new


def rpgd_keep_surgery(m, v):
    """Non-resample tick: shift every moment row left."""
    return shift_rows(m), shift_rows(v)


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
        """The ``n`` fresh sequences of a resample tick, from its draw."""
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

    def _make_batched_rpgd_step(self, num_slots: int, **kwargs):
        raise _not_ported("the batched-session RPGD step")

    # ---- the step -----------------------------------------------------------
    def _make_step_fn(self):
        K, U = self.num_rollouts, self.num_control_inputs
        low, high = self.action_low, self.action_high
        keep_k, shift = self.opt_keep_k, self.shift_previous
        lr, b1, b2, eps = self.learning_rate, self.adam_beta_1, self.adam_beta_2, self.adam_epsilon
        gclip = self.gradmax_clip
        alpha = self.maximum_entropy_alpha
        base_grad, cost_only = self._make_grad_and_cost_only()

        def spread_penalty_grad(Q):
            # Population (not sample) variance, as jnp.var.
            with torch.enable_grad():
                Qv = Q.detach().requires_grad_(True)
                pen = -0.5 * alpha * torch.sum(torch.log(torch.var(Qv, dim=0, correction=0) + 1e-8))
                (g,) = torch.autograd.grad(pen, Qv)
            return g

        def grad_fn(Q, s_tiled, u_prev, params):
            dQ = base_grad(Q, s_tiled, u_prev, params)
            return dQ + spread_penalty_grad(Q) if alpha > 0.0 else dQ

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
        cumulative weight exceeds it."""
        weights = torch.softmax(-(cost - torch.min(cost)) / self.particle_temperature, dim=0)
        cdf = torch.cumsum(weights, dim=0)
        idx = torch.searchsorted(cdf, uniforms * cdf[-1], right=True)
        return torch.clamp(idx, max=cost.shape[0] - 1)

    def _resample(self, draw, Q, cost, n: int) -> torch.Tensor:
        uniforms, jitter = draw
        resampled = Q[self.pick(cost, uniforms)] + self.interp.interpolate(jitter)
        return torch.clamp(resampled, self.action_low, self.action_high)
