"""Batched acrobot environment (counterpart of
control_toolkit_tpu/environments/acrobot.py): the rk4 plant step over the
port's acrobot dynamics, a swing-up test bench."""
from __future__ import annotations

import numpy as np
import torch

from control_toolkit_tpu_torch.environments.base import EnvironmentBatched
from control_toolkit_tpu_torch.models.dynamics import ACROBOT_DEFAULTS, acrobot_dynamics
from control_toolkit_tpu_torch.models.predictors import rk4_step
from control_toolkit_tpu_torch.utils import registry


@registry.environments.register("acrobot")
class AcrobotEnv(EnvironmentBatched):
    num_states = 4
    num_actions = 1
    action_low = np.array([-1.0], dtype=np.float32)
    action_high = np.array([1.0], dtype=np.float32)

    def __init__(self, batch_size: int = 1, dt: float = 0.05, seed=None,
                 actuator_noise: float = 0.0, params=None,
                 device: torch.device = torch.device("cpu")):
        super().__init__(batch_size, dt, seed, actuator_noise, device)
        self.params = dict(ACROBOT_DEFAULTS)
        if params:
            self.params.update(params)

    def step_dynamics(self, state, action, dt):
        return rk4_step(acrobot_dynamics, state, action, dt, self.params)

    def tip_height(self, state):
        t1, t2 = state[..., 0], state[..., 2]
        return -self.params["l1"] * torch.cos(t1) - self.params["l2"] * torch.cos(t1 + t2)

    def get_reward(self, state, action):
        return self.tip_height(state) - 0.01 * torch.sum(action**2, -1)

    def _sample_initial_state(self, generator):
        # hanging down with small noise
        return 0.05 * torch.randn((self.batch_size, 4), generator=generator, device=self.device)
