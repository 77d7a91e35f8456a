"""Batched gym-style environment base (counterpart of
control_toolkit_tpu/environments/base.py).

gymnasium's 5-tuple step API, a pure ``step_dynamics(state, action, dt)``
hook, batched actuator noise from an explicit generator, and batch-dim
expansion.  Environments are closed-loop test benches for the
controllers; they read their constants on every step, so nothing has to
be rebuilt when one changes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from control_toolkit_tpu_torch.utils.rng import make_generator


class EnvironmentBatched:
    num_states: int
    num_actions: int
    action_low: np.ndarray
    action_high: np.ndarray

    def __init__(self, batch_size: int = 1, dt: float = 0.02, seed: Optional[int] = None,
                 actuator_noise: float = 0.0, device: torch.device = torch.device("cpu")):
        self.batch_size = batch_size
        self.dt = float(dt)
        self.device = torch.device(device)
        self._generator = make_generator(seed, self.device, context=self.__class__.__name__)
        self.actuator_noise = float(actuator_noise)
        self.state: Optional[torch.Tensor] = None

    # ---- to implement ------------------------------------------------------
    def step_dynamics(self, state: torch.Tensor, action: torch.Tensor, dt: float) -> torch.Tensor:
        """Pure dynamics advance: [B,S],[B,U] -> [B,S]."""
        raise NotImplementedError

    def get_reward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def is_done(self, state: torch.Tensor) -> torch.Tensor:
        return torch.zeros(state.shape[:-1], dtype=torch.bool, device=state.device)

    def _sample_initial_state(self, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    # ---- gym-style API -----------------------------------------------------
    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self._generator = make_generator(seed, self.device, context=self.__class__.__name__)
        self.state = self._sample_initial_state(self._generator)
        return self.state.cpu().numpy(), {}

    def step(self, action) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Dict]:
        action = self._expand_batch(
            torch.as_tensor(np.asarray(action, np.float32), device=self.device), self.num_actions
        )
        if self.actuator_noise > 0.0:
            action = action + self.actuator_noise * torch.randn(
                action.shape, generator=self._generator, device=self.device
            )
        action = torch.clamp(
            action,
            torch.as_tensor(self.action_low, device=self.device),
            torch.as_tensor(self.action_high, device=self.device),
        )
        self.state = self.step_dynamics(self.state, action, self.dt)
        reward = self.get_reward(self.state, action)
        terminated = self.is_done(self.state)
        return (
            self.state.cpu().numpy(),
            reward.cpu().numpy(),
            terminated.cpu().numpy(),
            np.zeros_like(terminated.cpu().numpy()),
            {},
        )

    def _expand_batch(self, arr: torch.Tensor, last_dim: int) -> torch.Tensor:
        arr = torch.atleast_1d(arr)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1) if arr.shape[0] == last_dim else arr[:, None]
        if arr.shape[0] != self.batch_size:
            arr = arr.expand(self.batch_size, arr.shape[-1])
        return arr
