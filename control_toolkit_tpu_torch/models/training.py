"""Data for the learned models (counterpart of
control_toolkit_tpu/models/training.py).  Ported so far: the random-policy
transition collection; the fits (``fit_mlp_dynamics``,
``fit_gru_dynamics``, ...) are still to be ported (ROADMAP)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def collect_transitions(env, n_steps: int, seed: int = 0,
                        episode_length: int = 25) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random-policy transitions of a batched environment: (x_t [N,S], u_t
    [N,U], x_{t+1}), N = n_steps * batch.  Episodes restart every
    ``episode_length`` steps, so the visited states stay bounded."""
    rng = np.random.default_rng(seed)
    s, _ = env.reset(seed=seed)
    xs, us, xn = [], [], []
    for t in range(n_steps):
        u = rng.uniform(env.action_low, env.action_high,
                        size=(env.batch_size, env.num_actions)).astype(np.float32)
        s_next, *_ = env.step(u)
        xs.append(s.copy())
        us.append(u)
        xn.append(s_next.copy())
        s = s_next
        if (t + 1) % episode_length == 0:
            s, _ = env.reset(seed=int(rng.integers(1 << 30)))
    return np.concatenate(xs), np.concatenate(us), np.concatenate(xn)
