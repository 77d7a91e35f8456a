"""Batched cartpole environment (counterpart of
control_toolkit_tpu/environments/cartpole.py): the rk4 plant step over
the port's cartpole dynamics."""
from __future__ import annotations

import math

import numpy as np
import torch

from control_toolkit_tpu_torch.environments.base import EnvironmentBatched
from control_toolkit_tpu_torch.models.dynamics import CARTPOLE_DEFAULTS, cartpole_dynamics
from control_toolkit_tpu_torch.models.predictors import rk4_step
from control_toolkit_tpu_torch.utils import registry


@registry.environments.register("cartpole")
class CartpoleEnv(EnvironmentBatched):
    num_states = 4
    num_actions = 1
    action_low = np.array([-1.0], dtype=np.float32)
    action_high = np.array([1.0], dtype=np.float32)

    def __init__(self, batch_size: int = 1, dt: float = 0.02, seed=None,
                 actuator_noise: float = 0.0, params=None, start_upright: bool = True,
                 device: torch.device = torch.device("cpu")):
        super().__init__(batch_size, dt, seed, actuator_noise, device)
        self.params = dict(CARTPOLE_DEFAULTS)
        if params:
            self.params.update(params)
        self.start_upright = start_upright

    def step_dynamics(self, state, action, dt):
        return rk4_step(cartpole_dynamics, state, action, dt, self.params)

    def get_reward(self, state, action):
        angle = state[..., 2]
        pos = state[..., 0]
        return -(1.0 - torch.cos(angle)) - 0.01 * pos**2 - 0.01 * torch.sum(action**2, -1)

    def is_done(self, state):
        return torch.abs(state[..., 0]) > 10.0

    def _sample_initial_state(self, generator):
        noise = 0.05 * torch.randn((self.batch_size, 4), generator=generator, device=self.device)
        if self.start_upright:
            return noise
        # hanging-down start for swing-up experiments
        return torch.tensor([0.0, 0.0, math.pi, 0.0], device=self.device) + noise
