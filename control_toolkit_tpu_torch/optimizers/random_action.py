"""Random-shooting baseline optimizer (counterpart of
control_toolkit_tpu/optimizers/random_action.py): K uniform random control
sequences within the action bounds, scored by K1 (``ops/cost_rollout.py``)
through ``Optimizer._make_cost_only`` (the trajectory rollout when logging
is on); the control is the first action of the argmin-cost rollout.

Each step is a draw (``sample_actions``: Q ``[K, H, U]``) followed by a
deterministic ``update(state, s, params, Q)``, so tests can feed both
packages the same random numbers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.optimizers.base import Optimizer
from control_toolkit_tpu_torch.utils import registry


class RandomActionState(NamedTuple):
    generator: torch.Generator
    u_prev: torch.Tensor  # [U] last applied control (enters the cost's ccrc term)


@registry.optimizers.register("random-action-tf")
@registry.optimizers.register("random-action")
class RandomActionOptimizer(Optimizer):
    def _init_state(self, generator):
        return RandomActionState(
            generator=generator,
            u_prev=torch.zeros(self.num_control_inputs, dtype=torch.float32, device=self.device),
        )

    def sample_actions(self, state: RandomActionState) -> torch.Tensor:
        """This step's population: uniform in ``[low, high)``, ``[K, H, U]``."""
        r = torch.rand((self.num_rollouts, self.mpc_horizon, self.num_control_inputs),
                       generator=state.generator, dtype=torch.float32, device=self.device)
        return self.action_low + (self.action_high - self.action_low) * r

    def _make_step_fn(self):
        K = self.num_rollouts
        cost_only = None if self.optimizer_logging else self._make_cost_only()

        def update(state: RandomActionState, s, params, Q):
            s_tiled = s[:1].expand(K, -1).contiguous()
            if cost_only is not None:
                cost, traj = cost_only(s_tiled, Q, state.u_prev, params), None
            else:
                cost, traj = self._rollout_and_cost(s_tiled, Q, state.u_prev, params)
            u = Q[torch.argmin(cost), 0, :]
            diag = {"Q_logged": Q, "J_logged": cost} if self.optimizer_logging else {}
            if traj is not None:
                diag["rollout_trajectories_logged"] = traj
            return u, RandomActionState(generator=state.generator, u_prev=u), diag

        self.update = update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_actions(state))

        return step_fn
