"""Batched pendulum environment (counterpart of
control_toolkit_tpu/environments/pendulum.py): the rk4 plant step over
the port's pendulum dynamics."""
from __future__ import annotations

import math

import numpy as np
import torch

from control_toolkit_tpu_torch.environments.base import EnvironmentBatched
from control_toolkit_tpu_torch.models.dynamics import PENDULUM_DEFAULTS, pendulum_dynamics
from control_toolkit_tpu_torch.models.predictors import rk4_step
from control_toolkit_tpu_torch.utils import registry


@registry.environments.register("pendulum")
class PendulumEnv(EnvironmentBatched):
    num_states = 2
    num_actions = 1
    action_low = np.array([-1.0], dtype=np.float32)
    action_high = np.array([1.0], dtype=np.float32)

    def __init__(self, batch_size: int = 1, dt: float = 0.02, seed=None,
                 actuator_noise: float = 0.0, params=None, start_upright: bool = False,
                 device: torch.device = torch.device("cpu")):
        super().__init__(batch_size, dt, seed, actuator_noise, device)
        self.params = dict(PENDULUM_DEFAULTS)
        if params:
            self.params.update(params)
        self.start_upright = start_upright

    def step_dynamics(self, state, action, dt):
        return rk4_step(pendulum_dynamics, state, action, dt, self.params)

    def get_reward(self, state, action):
        return -(1.0 - torch.cos(state[..., 0])) - 0.01 * torch.sum(action**2, -1)

    def _sample_initial_state(self, generator):
        noise = 0.05 * torch.randn((self.batch_size, 2), generator=generator, device=self.device)
        if self.start_upright:
            return noise
        # hanging down
        return torch.tensor([math.pi, 0.0], device=self.device) + noise
