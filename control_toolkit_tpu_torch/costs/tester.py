"""Cost-function debugging harness (counterpart of
control_toolkit_tpu/costs/tester.py).

Buffers each named cost component per control step and plots them over
time.  A cost opts in by returning a dict of tensors from
``cost_components(states, inputs, previous_input, params)`` (cartpole,
the point mass, the quadrotors, the car and the arm); the tester keeps the
first rollout's first horizon step of each.  matplotlib is imported only
by ``plot``, so headless use needs nothing beyond torch and numpy
(``to_arrays``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class CostFunctionTester:
    def __init__(self, cost_function_wrapper):
        self.cost_function = getattr(cost_function_wrapper, "cost_function",
                                     cost_function_wrapper)
        if not hasattr(self.cost_function, "cost_components"):
            raise TypeError(f"{type(self.cost_function).__name__} does not expose "
                            "cost_components(states, inputs, previous_input, params)")
        self.buffers: Dict[str, List[np.ndarray]] = {}

    def collect_costs(self, states, inputs, previous_input=None, params=None) -> Dict:
        """The components of ``states [..., S]`` and ``inputs [..., U]``
        (tensors, or arrays taken as float32 CPU tensors), each buffered by
        its first entry."""
        params = params if params is not None else self.cost_function.current_params()
        comps = self.cost_function.cost_components(
            torch.as_tensor(states, dtype=torch.float32),
            torch.as_tensor(inputs, dtype=torch.float32), previous_input, params)
        for k, v in comps.items():
            # First rollout, first horizon step; ravel takes every rank,
            # 0-d components included.
            val = np.ravel(torch.as_tensor(v).detach().cpu().numpy())[0]
            self.buffers.setdefault(k, []).append(val)
        return comps

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.stack(v) for k, v in self.buffers.items()}

    def plot(self, show: bool = True):
        import matplotlib
        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        for k, v in self.to_arrays().items():
            plt.plot(v, label=k)
        plt.legend()
        plt.xlabel("control step")
        plt.ylabel("cost component")
        if show:
            plt.show()
        self.clear_buffers()
        return fig

    def clear_buffers(self) -> None:
        self.buffers = {}
