"""Batched 3-D quadrotor environment (counterpart of
control_toolkit_tpu/environments/quadrotor3d.py): twelve states, four
one-sided thrust inputs in [0, 1], the rk4 plant step over the port's
quadrotor3d dynamics.  Hover needs every rotor at m*g / (4*u_max)."""
from __future__ import annotations

import math

import numpy as np
import torch

from control_toolkit_tpu_torch.environments.base import EnvironmentBatched
from control_toolkit_tpu_torch.models.dynamics import QUADROTOR3D_DEFAULTS, quadrotor3d_dynamics
from control_toolkit_tpu_torch.models.predictors import rk4_step
from control_toolkit_tpu_torch.utils import registry


@registry.environments.register("quadrotor3d")
class Quadrotor3DEnv(EnvironmentBatched):
    num_states = 12
    num_actions = 4
    action_low = np.zeros(4, dtype=np.float32)
    action_high = np.ones(4, dtype=np.float32)

    def __init__(self, batch_size: int = 1, dt: float = 0.02, seed=None,
                 actuator_noise: float = 0.0, params=None,
                 device: torch.device = torch.device("cpu")):
        super().__init__(batch_size, dt, seed, actuator_noise, device)
        self.params = dict(QUADROTOR3D_DEFAULTS)
        if params:
            self.params.update(params)

    def step_dynamics(self, state, action, dt):
        return rk4_step(quadrotor3d_dynamics, state, action, dt, self.params)

    def get_reward(self, state, action):
        pos2 = state[..., 0] ** 2 + state[..., 1] ** 2 + (state[..., 2] - 1.0) ** 2
        tilt = state[..., 6] ** 2 + state[..., 7] ** 2
        return -pos2 - 0.1 * tilt - 0.01 * torch.sum(action**2, -1)

    def is_done(self, state):
        return (
            (torch.abs(state[..., 0]) > 10.0)
            | (torch.abs(state[..., 1]) > 10.0)
            | (torch.abs(state[..., 2]) > 10.0)
            | (torch.abs(state[..., 6]) > math.pi / 2)
            | (torch.abs(state[..., 7]) > math.pi / 2)
        )

    def _sample_initial_state(self, generator):
        # near hover around (0, 0, 1), slightly perturbed
        base = torch.tensor([0.0, 0.0, 1.0] + [0.0] * 9, device=self.device)
        noise = torch.tensor([0.3, 0.3, 0.3, 0.1, 0.1, 0.1, 0.05, 0.05, 0.1, 0.05, 0.05, 0.05],
                             device=self.device)
        return base + noise * torch.randn((self.batch_size, 12), generator=generator,
                                          device=self.device)
