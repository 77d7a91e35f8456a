"""Gradient (Adam) trajectory optimizer (counterpart of
control_toolkit_tpu/optimizers/gradient.py).

A persistent population of K uniform random control sequences is
optimized with Adam through the rollout for ``gradient_steps`` iterations
per tick (``warmup_iterations`` on the first tick when ``warmup`` is on),
each rollout's gradient clipped to norm ``gradmax_clip`` and the controls
clipped to the action bounds after every update; the control is the first
action of the argmin-cost rollout.  Warm start: the population shifts one
step left with a fresh uniform random tail column, and the Adam moments
shift left zero-padded.  Gradients come from K7 and the final costs from
K1 through ``Optimizer._make_grad_and_cost_only``.

Each tick is a draw (``sample_tail``: the fresh tail column) followed by a
deterministic ``update(state, s, params, tail)``.  The batched-mpc
controller's B-session step (``_make_batched_gradient_step``) takes every
session's gradients in one launch of a gradient kernel's session-row form
an Adam iteration and scores them in one of its cost kernel's
(``kernel_families/batched.py``).  Not ported (``NotImplementedError``,
ROADMAP): the policy warm start.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.ops.common import (
    AdamState, adam_descent, adam_init, shift_adam_moments,
)
from control_toolkit_tpu_torch.optimizers.base import Optimizer, _not_ported
from control_toolkit_tpu_torch.utils import registry

logger = logging.getLogger(__name__)


class GradientState(NamedTuple):
    generator: torch.Generator
    Q: torch.Tensor      # [K, H, U] persistent population
    adam: AdamState      # over [K, H, U]
    count: int           # host tick counter
    u_prev: torch.Tensor


@registry.optimizers.register("gradient-tf")
@registry.optimizers.register("gradient")
class GradientOptimizer(Optimizer):
    def __init__(
        self,
        *,
        gradient_steps: int = 5,
        initial_action_stdev: float = 0.5,
        learning_rate: float = 0.05,
        adam_beta_1: float = 0.9,
        adam_beta_2: float = 0.999,
        adam_epsilon: float = 1e-7,
        gradmax_clip: float = 5.0,
        rtol: float = 1e-3,
        warmup: bool = False,
        warmup_iterations: int = 250,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if self.calculate_optimal_trajectory:
            raise _not_ported("calculate_optimal_trajectory")
        self.gradient_steps = int(gradient_steps)
        self.initial_action_stdev = float(initial_action_stdev)
        self.learning_rate = float(learning_rate)
        self.adam_beta_1 = float(adam_beta_1)
        self.adam_beta_2 = float(adam_beta_2)
        self.adam_epsilon = float(adam_epsilon)
        self.gradmax_clip = float(gradmax_clip)
        self.rtol = float(rtol)
        if self.rtol != 1e-3:
            logger.warning(
                "rtol is accepted for reference-config parity but the "
                "fixed-trip-count Adam loop does not early-stop; tuning "
                "it has no effect"
            )
        self.warmup = bool(warmup)
        self.warmup_iterations = int(warmup_iterations)

    def _uniform(self, generator: torch.Generator, shape) -> torch.Tensor:
        r = torch.rand(shape, generator=generator, dtype=torch.float32, device=self.device)
        return self.action_low + (self.action_high - self.action_low) * r

    def _init_state(self, generator):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        return GradientState(
            generator=generator, Q=self._uniform(generator, (K, H, U)),
            adam=adam_init((K, H, U), self.device), count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def sample_tail(self, state: GradientState) -> torch.Tensor:
        """This tick's fresh tail column ``[K, 1, U]``."""
        return self._uniform(state.generator, (self.num_rollouts, 1, self.num_control_inputs))

    def _apply_policy_guess(self, state, plan):
        raise _not_ported("initial_guess_policy")

    def sample_slot_tails(self, generators, mask) -> torch.Tensor:
        """The batched step's draw, the fresh tail columns ``[B, K, 1, U]``:
        one from each active slot's generator, zeros for a frozen slot (it
        draws nothing)."""
        shape = (self.num_rollouts, 1, self.num_control_inputs)
        zeros = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return torch.stack([self._uniform(g, shape) if on else zeros
                            for g, on in zip(generators, mask)])

    def _make_batched_gradient_step(self, num_slots: int, per_slot_dyn=()):
        """B-session gradient-tf step for the batched-mpc controller (JAX
        ``gradient.py:111-194``): RPGD's batched step without the
        resampling (``RPGDOptimizer._make_batched_rpgd_step``): one launch
        of the gradient kernel's session-row form an Adam iteration, one of
        its cost kernel's for the final costs, then per session the
        argmin's first control, the shift with the slot's fresh tail and
        the moments' shift.

        Returns ``(step, update)``: ``step(states, s [B,1,S], dyn, cost,
        attrs, mask [B]) -> (u [B,U], states', costs [B,K])`` over the
        stacked state, each active slot drawing its tail from its own
        generator (``sample_slot_tails``); ``update(states, s, dyn, cost,
        attrs, tails [B,K,1,U])`` is the deterministic part, for tests that
        feed the JAX draws.  Requires ``warmup=False``."""
        if self.warmup:
            raise NotImplementedError(
                "batched gradient kernel path requires warmup=False (shared Adam-loop trip "
                "count)")
        B, K = int(num_slots), self.num_rollouts
        H, U = self.mpc_horizon, self.num_control_inputs
        gcall, ccall, pack = self._bind_batched_grad_kernels(B, per_slot_dyn=per_slot_dyn)
        low, high = self.action_low, self.action_high
        lr, b1, b2, eps = self.learning_rate, self.adam_beta_1, self.adam_beta_2, self.adam_epsilon
        gclip = self.gradmax_clip

        def update(states: GradientState, s, dyn, cost, attrs, tails):
            pvec_b = pack(states.u_prev, dyn, cost, attrs)
            s0 = s[:, 0, :].repeat_interleave(K, dim=0)                      # [B*K, S]
            Q, adam = adam_descent(
                states.Q, states.adam,
                lambda Q: gcall(s0, Q.reshape(B * K, H, U), pvec_b, dyn,
                                cost)[1].reshape(B, K, H, U),
                self.gradient_steps, lr, b1, b2, eps, gclip, low, high)
            costs = ccall(s0, Q.reshape(B * K, H, U), pvec_b, dyn, cost)       # [B, K]
            best = torch.argmin(costs, dim=1)
            u = torch.take_along_dim(Q[:, :, 0, :], best[:, None, None], dim=1)[:, 0]
            new_state = GradientState(
                generator=states.generator, Q=torch.cat([Q[:, :, 1:, :], tails], dim=2),
                adam=shift_adam_moments(adam), count=states.count + 1, u_prev=u,
            )
            return u, new_state, costs

        def step(states, s, dyn, cost, attrs, mask):
            return update(states, s, dyn, cost, attrs,
                          self.sample_slot_tails(states.generator, mask))

        return step, update

    def _make_step_fn(self):
        K = self.num_rollouts
        low, high = self.action_low, self.action_high
        lr, b1, b2, eps = self.learning_rate, self.adam_beta_1, self.adam_beta_2, self.adam_epsilon
        gclip = self.gradmax_clip
        grad_fn, cost_only = self._make_grad_and_cost_only()

        def update(state: GradientState, s, params, tail):
            s_tiled = s[:1].expand(K, -1).contiguous()
            iterations = self.warmup_iterations if self.warmup and state.count == 0 \
                else self.gradient_steps
            Q, adam = adam_descent(state.Q, state.adam,
                                   lambda Q: grad_fn(Q, s_tiled, state.u_prev, params),
                                   iterations, lr, b1, b2, eps, gclip, low, high)
            if cost_only is not None:
                cost, traj = cost_only(s_tiled, Q, state.u_prev, params), None
            else:
                cost, traj = self._rollout_and_cost(s_tiled, Q, state.u_prev, params)
            u_nom = Q.index_select(0, torch.argmin(cost).reshape(1))   # [1, H, U]
            u = u_nom[0, 0, :]
            diag = {"J_logged": cost, "u_nom": u_nom}
            if self.optimizer_logging:
                diag["Q_logged"] = Q
            if traj is not None:
                diag["rollout_trajectories_logged"] = traj
            new_state = GradientState(
                generator=state.generator, Q=torch.cat([Q[:, 1:, :], tail], dim=1),
                adam=shift_adam_moments(adam), count=state.count + 1, u_prev=u,
            )
            return u, new_state, diag

        self.update = update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_tail(state))

        return step_fn
