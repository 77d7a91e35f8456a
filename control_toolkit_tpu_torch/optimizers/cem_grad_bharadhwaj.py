"""CEM with Adam refinement (Bharadhwaj et al. 2020, the full variant;
counterpart of control_toolkit_tpu/optimizers/cem_grad_bharadhwaj.py).

Each control step seeds the elites afresh from the CEM Gaussian
(``cem_best_k`` rows); each outer iteration keeps the current elites,
resamples the other K - k rows from the Gaussian, clips, takes one Adam
step on all K along the gradient of the summed trajectory cost (each
rollout's gradient norm-clipped to ``gradmax_clip``), clips again, scores
the moved population, re-elects the elites and refits the Gaussian.  The
control is the best elite's first action; sigma is clipped to
``[cem_stdev_min, 10.0]`` (the reference's cap) and both shift one step.
The Adam moments ``[K, H, U]`` and their counter persist across control
steps, unshifted, as in the reference.  The first control step runs
``warmup_iterations`` when ``warmup`` is on.

The gradient and the cost come from ``Optimizer._make_grad_and_cost_only``
(K7 and K1 over the ODE; K8, K9 or K10 and their cost kernels over the
learned models).  Each step is a draw (``sample_draws``: the elite seed's
normals ``[k, H, U]``, then one ``[K - k, H, U]`` per outer iteration)
followed by a deterministic ``update(state, s, params, draws)``: a first
carry (``start``), then an outer iteration at a time (``iterate``).  As
in the JAX package, the class has no policy warm start: an
``initial_guess_policy`` is accepted and ignored.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.ops.common import (
    AdamState, adam_init, adam_update, clip_by_norm, elite_indices,
)
from control_toolkit_tpu_torch.optimizers.base import Optimizer
from control_toolkit_tpu_torch.optimizers.cem import cem_shift_distribution, cem_trip_count, refit
from control_toolkit_tpu_torch.optimizers.cem_naive_grad import GRAD_CEM_STDEV_MAX
from control_toolkit_tpu_torch.utils import registry


class CEMGradState(NamedTuple):
    generator: torch.Generator
    dist_mue: torch.Tensor  # [1, H, U]
    stdev: torch.Tensor     # [1, H, U]
    adam: AdamState         # over [K, H, U]
    count: int              # host control-step counter
    u_prev: torch.Tensor    # [U]


@registry.optimizers.register("cem-grad-bharadhwaj-tf")
@registry.optimizers.register("cem-grad-bharadhwaj")
class CEMGradBharadhwajOptimizer(Optimizer):
    def __init__(
        self,
        *,
        cem_outer_it: int = 2,
        cem_initial_action_stdev: float = 2.0,
        cem_stdev_min: float = 1e-6,
        cem_best_k: int = 8,
        learning_rate: float = 0.05,
        adam_beta_1: float = 0.9,
        adam_beta_2: float = 0.999,
        adam_epsilon: float = 1e-8,
        gradmax_clip: float = 5.0,
        warmup: bool = False,
        warmup_iterations: int = 250,
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
        self.learning_rate = float(learning_rate)
        self.adam_beta_1 = float(adam_beta_1)
        self.adam_beta_2 = float(adam_beta_2)
        self.adam_epsilon = float(adam_epsilon)
        self.gradmax_clip = float(gradmax_clip)
        self.warmup = bool(warmup)
        self.warmup_iterations = int(warmup_iterations)

    def _init_state(self, generator):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        u_mid = 0.5 * (self.action_low + self.action_high)
        return CEMGradState(
            generator=generator,
            dist_mue=u_mid.expand(1, H, U).to(torch.float32).clone(),
            stdev=torch.full((1, H, U), self.cem_initial_action_stdev, dtype=torch.float32,
                             device=self.device),
            adam=adam_init((K, H, U), self.device),
            count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def sample_draws(self, state: CEMGradState) -> list:
        """This step's draws: the elite seed's normals ``[k, H, U]``, then
        the resampled rows' ``[K - k, H, U]`` for each outer iteration."""
        K, H, U, k = self.num_rollouts, self.mpc_horizon, self.num_control_inputs, self.cem_best_k
        g = state.generator
        return [torch.randn((n, H, U), generator=g, dtype=torch.float32, device=self.device)
                for n in [k] + [K - k] * cem_trip_count(self, state.count)]

    def _make_step_fn(self):
        K, U = self.num_rollouts, self.num_control_inputs
        low, high = self.action_low, self.action_high
        best_k, lr, gclip = self.cem_best_k, self.learning_rate, self.gradmax_clip
        b1, b2, eps = self.adam_beta_1, self.adam_beta_2, self.adam_epsilon
        u_mid = 0.5 * (low + high)
        grad_fn, cost_only = self._make_grad_and_cost_only()
        want_Q = self.optimizer_logging

        def start(state: CEMGradState, seed_z):
            """The first carry: the distribution, the Adam state and a fresh
            elite seed (reference :163)."""
            return {"mue": state.dist_mue, "std": state.stdev, "adam": state.adam,
                    "elite_Q": state.dist_mue + state.stdev * seed_z}

        def iterate(carry, s_tiled, u_prev, params, z):
            """One outer iteration from ``carry``: the elites kept and K - k
            rows resampled, one Adam step, the moved population's costs, the
            elites ``idx`` (best first) and the refit."""
            Q = torch.clamp(torch.cat([carry["elite_Q"], carry["mue"] + carry["std"] * z], dim=0),
                            low, high)
            dQ = clip_by_norm(grad_fn(Q, s_tiled, u_prev, params), gclip, axes=(1, 2))
            adam, delta = adam_update(carry["adam"], dQ, lr, b1, b2, eps)
            Qn = torch.clamp(Q - delta, low, high)
            logged = {"Q_logged": Qn} if want_Q else {}
            if cost_only is not None:
                cost = cost_only(s_tiled, Qn, u_prev, params)
            else:
                cost, logged["rollout_trajectories_logged"] = self._rollout_and_cost(
                    s_tiled, Qn, u_prev, params)
            idx = elite_indices(cost, best_k)
            elite_Q = Qn[idx]
            mue, std = refit(elite_Q)
            return dict(carry, mue=mue, std=std, adam=adam, elite_Q=elite_Q, cost=cost, idx=idx,
                        **logged)

        def update(state: CEMGradState, s, params, draws):
            its = cem_trip_count(self, state.count)
            if len(draws) != 1 + its:
                raise ValueError(f"step {state.count}: {len(draws)} draws for the elite seed and "
                                 f"{its} outer iterations")
            s_tiled = s[:1].expand(K, -1).contiguous()
            carry = start(state, draws[0])
            for z in draws[1:]:
                carry = iterate(carry, s_tiled, state.u_prev, params, z)
            elite_Q = carry["elite_Q"]
            u = elite_Q[0, 0, :]
            mue_s, std_s = cem_shift_distribution(carry["mue"], carry["std"], u_mid,
                                                  self.cem_stdev_min,
                                                  self.cem_initial_action_stdev, U,
                                                  GRAD_CEM_STDEV_MAX)
            new_state = CEMGradState(generator=state.generator, dist_mue=mue_s, stdev=std_s,
                                     adam=carry["adam"], count=state.count + 1, u_prev=u)
            diag = {k: carry[k] for k in ("Q_logged", "rollout_trajectories_logged")
                    if k in carry}
            return u, new_state, dict(diag, J_logged=carry["cost"], u_nom=elite_Q[:1])

        self.start, self.iterate, self.update = start, iterate, update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
