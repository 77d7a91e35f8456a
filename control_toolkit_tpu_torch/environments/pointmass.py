"""Batched planar point-mass environment (counterpart of
control_toolkit_tpu/environments/pointmass.py): the multi-input test
bench, two force inputs, the rk4 plant step over the port's pointmass
dynamics."""
from __future__ import annotations

import numpy as np
import torch

from control_toolkit_tpu_torch.environments.base import EnvironmentBatched
from control_toolkit_tpu_torch.models.dynamics import POINTMASS_DEFAULTS, pointmass_dynamics
from control_toolkit_tpu_torch.models.predictors import rk4_step
from control_toolkit_tpu_torch.utils import registry


@registry.environments.register("pointmass")
class PointMassEnv(EnvironmentBatched):
    num_states = 4
    num_actions = 2
    action_low = np.array([-1.0, -1.0], dtype=np.float32)
    action_high = np.array([1.0, 1.0], dtype=np.float32)

    def __init__(self, batch_size: int = 1, dt: float = 0.02, seed=None,
                 actuator_noise: float = 0.0, params=None,
                 device: torch.device = torch.device("cpu")):
        super().__init__(batch_size, dt, seed, actuator_noise, device)
        self.params = dict(POINTMASS_DEFAULTS)
        if params:
            self.params.update(params)

    def step_dynamics(self, state, action, dt):
        return rk4_step(pointmass_dynamics, state, action, dt, self.params)

    def get_reward(self, state, action):
        pos2 = state[..., 0] ** 2 + state[..., 1] ** 2
        return -pos2 - 0.01 * torch.sum(action**2, -1)

    def is_done(self, state):
        return (torch.abs(state[..., 0]) > 20.0) | (torch.abs(state[..., 1]) > 20.0)

    def _sample_initial_state(self, generator):
        # a random position in [-2, 2]^2, at rest
        pos = 4.0 * torch.rand((self.batch_size, 2), generator=generator, device=self.device) - 2.0
        return torch.cat([pos, torch.zeros((self.batch_size, 2), device=self.device)], dim=1)
