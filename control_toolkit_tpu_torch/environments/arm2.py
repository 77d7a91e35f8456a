"""Batched two-link manipulator environment (counterpart of
control_toolkit_tpu/environments/arm2.py): the end-effector reaching
bench, torques on both joints, the rk4 plant step over the port's arm2
dynamics; the reward is minus the fingertip's squared distance to
``target``.  It reads ``target`` on every call, so a retarget needs
nothing rebuilt."""
from __future__ import annotations

import numpy as np
import torch

from control_toolkit_tpu_torch.environments.base import EnvironmentBatched
from control_toolkit_tpu_torch.models.dynamics import (
    ARM2_DEFAULTS, arm2_dynamics, arm2_end_effector,
)
from control_toolkit_tpu_torch.models.predictors import rk4_step
from control_toolkit_tpu_torch.utils import registry


@registry.environments.register("arm2")
class Arm2Env(EnvironmentBatched):
    num_states = 4
    num_actions = 2
    action_low = np.array([-1.0, -1.0], dtype=np.float32)
    action_high = np.array([1.0, 1.0], dtype=np.float32)

    def __init__(self, batch_size: int = 1, dt: float = 0.02, seed=None,
                 actuator_noise: float = 0.0, params=None, target=(0.6, 0.4),
                 device: torch.device = torch.device("cpu")):
        super().__init__(batch_size, dt, seed, actuator_noise, device)
        self.params = dict(ARM2_DEFAULTS)
        if params:
            self.params.update(params)
        self.target = np.asarray(target, np.float32)

    def step_dynamics(self, state, action, dt):
        return rk4_step(arm2_dynamics, state, action, dt, self.params)

    def end_effector(self, state):
        return arm2_end_effector(state[..., 0], state[..., 2],
                                 self.params["l1"], self.params["l2"])

    def get_reward(self, state, action):
        x, y = self.end_effector(state)
        d2 = (x - float(self.target[0])) ** 2 + (y - float(self.target[1])) ** 2
        return -d2 - 0.01 * torch.sum(action**2, -1)

    def _sample_initial_state(self, generator):
        # hanging down with small noise
        return 0.05 * torch.randn((self.batch_size, 4), generator=generator, device=self.device)
