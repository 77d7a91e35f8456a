"""iCEM — improved Cross-Entropy Method planner (Pinneri et al., CoRL 2020;
counterpart of control_toolkit_tpu/optimizers/icem.py).  Beyond vanilla
CEM (``optimizers/cem.py``, whose shift, trip count and diagnostics it
shares):

* colored-noise sampling: perturbations with a ``(1/f)^beta`` spectrum
  over the horizon (``ops/colored_noise.py``);
* an elite buffer across iterations and control steps: the best
  ``round(icem_keep_elites_frac * cem_best_k)`` elites rejoin every
  population, shifted one step at the control-step boundary (the tail
  repeats each elite's last action);
* the mean candidate: the distribution mean is one population member.

The population ``[fresh; buffer; mean]`` is clipped and scored by K1
(``ops/cost_rollout.py``) through ``Optimizer._make_cost_only``.  Each
step is a draw per outer iteration (``sample_draws``: the white spectral
coefficients ``[2, n_fresh, U, F]``) followed by a deterministic
``update(state, s, params, draws)``.  As in the JAX package, every
iteration uses the full K (the paper's population decay is not ported
there either).  The policy warm start centres the sampling mean and the
elite buffer on the policy's plan (``_apply_policy_guess``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.ops.colored_noise import powerlaw_shape, powerlaw_white
from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.optimizers.base import Optimizer
from control_toolkit_tpu_torch.optimizers.cem import (
    cem_base_carry, cem_diag, cem_shift_distribution, cem_trip_count, refit,
)
from control_toolkit_tpu_torch.utils import registry


class ICEMState(NamedTuple):
    generator: torch.Generator
    dist_mue: torch.Tensor  # [1, H, U]
    stdev: torch.Tensor     # [1, H, U]
    elites: torch.Tensor    # [n_keep, H, U] elite buffer (already time-shifted)
    count: int              # host control-step counter
    u_prev: torch.Tensor    # [U]


@registry.optimizers.register("icem-tf")
@registry.optimizers.register("icem")
class ICEMOptimizer(Optimizer):
    def __init__(
        self,
        *,
        cem_outer_it: int = 3,
        cem_initial_action_stdev: float = 0.5,
        cem_stdev_min: float = 0.01,
        cem_best_k: int = 40,
        icem_colored_noise_beta: float = 2.0,
        icem_keep_elites_frac: float = 0.3,
        icem_add_mean_sample: bool = True,
        warmup: bool = False,
        warmup_iterations: int = 100,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.cem_outer_it = int(cem_outer_it)
        self.cem_initial_action_stdev = float(cem_initial_action_stdev)
        self.cem_stdev_min = float(cem_stdev_min)
        self.cem_best_k = int(cem_best_k)
        self.beta = float(icem_colored_noise_beta)
        self.n_keep = max(0, int(round(float(icem_keep_elites_frac) * self.cem_best_k)))
        self.add_mean = bool(icem_add_mean_sample)
        self.warmup = bool(warmup)
        self.warmup_iterations = int(warmup_iterations)
        if self.cem_best_k > self.num_rollouts:
            raise ValueError(
                f"cem_best_k={self.cem_best_k} exceeds num_rollouts={self.num_rollouts}"
            )
        if self.n_keep > self.cem_best_k:
            raise ValueError(
                f"icem_keep_elites_frac={icem_keep_elites_frac} keeps {self.n_keep} elites "
                f"but only cem_best_k={self.cem_best_k} are selected (frac must be <= 1)"
            )
        self._n_fresh = self.num_rollouts - self.n_keep - int(self.add_mean)
        if self._n_fresh <= 0:
            raise ValueError(
                f"num_rollouts={self.num_rollouts} leaves no room for fresh samples after "
                f"{self.n_keep} kept elites{' + the mean candidate' if self.add_mean else ''}"
            )

    def _init_state(self, generator):
        H, U = self.mpc_horizon, self.num_control_inputs
        u_mid = (0.5 * (self.action_low + self.action_high)).to(torch.float32)
        return ICEMState(
            generator=generator,
            dist_mue=u_mid.expand(1, H, U).clone(),
            stdev=torch.full((1, H, U), self.cem_initial_action_stdev, dtype=torch.float32,
                             device=self.device),
            elites=u_mid.expand(self.n_keep, H, U).clone(),
            count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def _apply_policy_guess(self, state, plan):
        """The sampling mean and every elite-buffer row set to a
        heuristic-policy rollout: iCEM re-injects its elites, so a stale
        mid-range row would compete with the seeded mean (JAX
        ``icem.py:127``)."""
        plan = plan.to(state.dist_mue.dtype)
        return state._replace(dist_mue=plan[None],
                              elites=plan.expand(state.elites.shape).clone())

    def sample_draws(self, state: ICEMState) -> list:
        """This step's draws, one per outer iteration: the white spectral
        coefficients of the ``[n_fresh, U, H]`` colored noise."""
        return [powerlaw_white(state.generator, self.mpc_horizon,
                               (self._n_fresh, self.num_control_inputs), self.device)
                for _ in range(cem_trip_count(self, state.count))]

    def _make_step_fn(self):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        low, high = self.action_low, self.action_high
        best_k, n_keep = self.cem_best_k, self.n_keep
        u_mid = 0.5 * (low + high)
        cost_only = None if self.optimizer_logging else self._make_cost_only()
        want_Q = self.optimizer_logging

        def update(state: ICEMState, s, params, draws):
            if len(draws) != cem_trip_count(self, state.count):
                raise ValueError(f"step {state.count}: {len(draws)} draws for "
                                 f"{cem_trip_count(self, state.count)} outer iterations")
            s_tiled = s[:1].expand(K, -1).contiguous()
            carry = cem_base_carry(state.dist_mue, state.stdev, K, H, U, self.num_states,
                                   want_Q, cost_only is None)
            buf = state.elites
            for white in draws:
                mue, std = carry["mue"], carry["std"]
                # Colored along the horizon: [n_fresh, U, H], then [n_fresh, H, U].
                noise = powerlaw_shape(white, self.beta, H).transpose(1, 2)
                rows = [mue + noise * std] + ([buf] if n_keep else []) + ([mue] if self.add_mean
                                                                         else [])
                Q = torch.clamp(torch.cat(rows, dim=0), low, high)
                logged = {"Q": Q} if want_Q else {}
                if cost_only is not None:
                    cost = cost_only(s_tiled, Q, state.u_prev, params)
                else:
                    cost, logged["traj"] = self._rollout_and_cost(s_tiled, Q, state.u_prev,
                                                                  params)
                elite_Q = Q[elite_indices(cost, best_k)]
                mue, std = refit(elite_Q)
                buf = elite_Q[:n_keep]
                carry.update(mue=mue, std=std, elite0=elite_Q[0], cost=cost, **logged)
            u = carry["elite0"][0, :]
            mue, std = cem_shift_distribution(carry["mue"], carry["std"], u_mid,
                                              self.cem_stdev_min, self.cem_initial_action_stdev, U)
            buf = torch.cat([buf[:, 1:, :], buf[:, -1:, :]], dim=1)
            new_state = ICEMState(generator=state.generator, dist_mue=mue, stdev=std, elites=buf,
                                  count=state.count + 1, u_prev=u)
            return u, new_state, cem_diag(carry, want_Q, cost_only is None)

        self.update = update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
