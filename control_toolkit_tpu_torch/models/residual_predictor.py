"""Residual dynamics predictor: analytic ODE base + learned MLP correction
(counterpart of control_toolkit_tpu/models/residual_predictor.py).

The adaptive-MPC composition ``x_{h+1} = ode_step(x, u) + mlp([x, u])``.
The MLP's output layer starts at zero, so a fresh residual predictor is
exactly its base ODE predictor; online system identification
(``models/online_sysid.py``) then fits the correction to observed
transitions while the controller runs.  The params are ``{"base": <the
ODE's constants>, "res": <the MLP's weight tensors>}``: the controller
re-places ``res`` when the predictor's dict object changes
(``set_residual``, ``load_residual``), so an install reaches the next step
with nothing rebuilt.  The rollout kernels K12 and K9
(``ops/residual_rollout.py``, ``ops/residual_grad_cost_rollout.py``) read
the base's constants from the packed vector and the residual's tensors
per call.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from control_toolkit_tpu_torch.models.networks import load_net, mlp_apply, mlp_init, save_net
from control_toolkit_tpu_torch.models.predictors import ODEPredictor, Predictor, scan_rollout
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.device import place, resolve_device


@registry.predictors.register("ODE+res")
class ResidualPredictor(Predictor):
    """ODE base + additive next-state MLP residual on ``device``.  The
    initial weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` (the JAX package's scales, not its draws).  ``fast_math``
    goes to the base (its polynomial-trig plant)."""

    def __init__(
        self,
        environment_name: str = "cartpole",
        dt: float = 0.02,
        integrator: str = "rk4",
        intermediate_steps: int = 1,
        fast_math: bool = False,
        hiddens: Sequence[int] = (32, 32),
        seed: int = 0,
        base_params: Optional[Dict] = None,
        device: Optional[torch.device] = None,
    ):
        self.base = ODEPredictor(environment_name=environment_name, dt=dt, integrator=integrator,
                                 intermediate_steps=intermediate_steps, params=base_params,
                                 fast_math=fast_math)
        S, U = self.base.num_states, self.base.num_control_inputs
        self.num_states, self.num_control_inputs = S, U
        self.environment_name = self.base.environment_name
        self.dt = self.base.dt
        self.integrator = integrator
        self.intermediate_steps = int(intermediate_steps)
        self.fast_math = self.base.fast_math
        self.hiddens = tuple(int(h) for h in hiddens)
        self.device = resolve_device(device)

        res = mlp_init(torch.Generator().manual_seed(int(seed)), [S + U, *self.hiddens, S])
        last = f"w{len(self.hiddens)}"
        res[last] = torch.zeros_like(res[last])  # residual == 0 until fitted
        self.set_residual(res)

        base_step = self.base.single_step

        def single_step(x, u, params):
            xb = base_step(x, u, params["base"])
            return xb + mlp_apply(params["res"], torch.cat([x, u], dim=-1))

        self._single_step = single_step

    def set_residual(self, res: Dict) -> None:
        """Install residual weights (tensors or arrays), as float32 tensors
        on the predictor's device in a new dict: the controller's next step
        sees the new object and places it, nothing is rebuilt."""
        self._res = place(res, self.device)

    def save_residual(self, path) -> None:
        """Write the residual in ``networks.save_net``'s layout, with the JAX
        package's meta, so either package's ``load_residual`` reads it."""
        save_net(path, self._res, meta={
            "kind": "residual", "hiddens": list(self.hiddens),
            "num_states": self.num_states, "num_control_inputs": self.num_control_inputs,
        })

    def load_residual(self, path) -> None:
        """Load a residual written by either package's ``save_residual``;
        refuses one for other state or control widths."""
        params, meta = load_net(path)
        for field, have in (("num_states", self.num_states),
                            ("num_control_inputs", self.num_control_inputs)):
            if int(meta.get(field, have)) != have:
                raise ValueError(f"residual checkpoint is for {field}={meta.get(field)}, "
                                 f"predictor has {have}")
        if "hiddens" in meta:
            self.hiddens = tuple(int(h) for h in meta["hiddens"])
        self.set_residual(params)

    def default_params(self) -> Dict:
        return {"base": self.base.default_params(), "res": self._res}

    @property
    def single_step(self):
        return self._single_step

    def rollout(self, s0, Q, params=None):
        p = self.default_params() if params is None else params
        return scan_rollout(self._single_step, s0, Q, p)

    def copy(self) -> "ResidualPredictor":
        new = ResidualPredictor.__new__(ResidualPredictor)
        new.__dict__.update(self.__dict__)
        return new
