"""Online system identification: fit the residual dynamics model while the
controller runs (counterpart of control_toolkit_tpu/models/online_sysid.py).

An ``OnlineSysId`` attached to an MPC controller whose predictor is a
``ResidualPredictor`` (spec ``"ODE+res"``) records the transitions the
plant produced and fits the residual MLP to the base model's one-step
error, on the predictor's device.  ``apply`` installs the fit with
``set_residual``: the controller places the new weights at its next step,
and nothing is rebuilt.

    sysid = OnlineSysId(ctrl)
    for t in range(T):
        u = ctrl.step(s)
        s_next = plant(s, u)
        sysid.observe(s, u, s_next)
        if t % 25 == 24:
            sysid.fit_and_apply(steps=200)
        s = s_next

The fit is Adam in optax's form (``m̂ / (sqrt(v̂) + eps)``, eps 1e-8), which
``torch.optim.Adam`` computes; its moments persist across fit -> apply ->
fit and are dropped when a fit is discarded (a second ``fit`` without
``apply``).  Each step's minibatch indices are drawn from the instance's
generator, or given (``fit(steps, indices)``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from control_toolkit_tpu_torch.models.networks import mlp_apply
from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor
from control_toolkit_tpu_torch.utils.rng import make_generator


class OnlineSysId:
    """Ring buffer of observed transitions + residual fitting.

    ``controller`` is an MPCController whose predictor resolves to a
    ResidualPredictor; alternatively pass ``predictor=`` directly."""

    def __init__(self, controller=None, predictor: Optional[ResidualPredictor] = None,
                 capacity: int = 4096, batch_size: int = 256, learning_rate: float = 1e-3,
                 seed: int = 0):
        if predictor is None:
            if controller is None:
                raise ValueError("need a controller or a predictor")
            predictor = getattr(controller.predictor, "predictor", controller.predictor)
        if not isinstance(predictor, ResidualPredictor):
            raise TypeError("OnlineSysId needs a ResidualPredictor (predictor spec 'ODE+res'); "
                            f"got {type(predictor).__name__}")
        self.controller = controller
        self.predictor = predictor
        self.device = predictor.device
        S, U = predictor.num_states, predictor.num_control_inputs
        self.capacity = int(capacity)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self._s = np.zeros((self.capacity, S), np.float32)
        self._u = np.zeros((self.capacity, U), np.float32)
        self._sn = np.zeros((self.capacity, S), np.float32)
        self._head = 0
        self._count = 0
        self._generator = make_generator(seed, self.device, context="OnlineSysId")
        self._params = None      # the fit's weight tensors, which Adam's moments follow
        self._adam = None
        self._pending = False    # the last fit produced weights not yet applied
        self._fitted_res = None

    # ---- data ---------------------------------------------------------------
    def observe(self, s, u, s_next) -> None:
        """Record one observed plant transition."""
        i = self._head
        self._s[i] = np.reshape(np.asarray(s, np.float32), (-1,))
        self._u[i] = np.reshape(np.asarray(u, np.float32), (-1,))
        self._sn[i] = np.reshape(np.asarray(s_next, np.float32), (-1,))
        self._head = (i + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)

    def __len__(self) -> int:
        return self._count

    def _buffers(self):
        n = self._count
        return tuple(torch.as_tensor(b[:n], device=self.device) for b in (self._s, self._u, self._sn))

    def _predict(self, res: Dict, xs, us) -> torch.Tensor:
        base = self.predictor.base
        return base.single_step(xs, us, base.default_params()) + mlp_apply(
            res, torch.cat([xs, us], dim=-1))

    def _loss(self, res: Dict, xs, us, sn) -> torch.Tensor:
        """Mean squared one-step error over the recorded (valid) rows."""
        return torch.mean(torch.mean((self._predict(res, xs, us) - sn) ** 2, dim=-1))

    # ---- fitting ------------------------------------------------------------
    def fit(self, steps: int = 200, indices=None) -> Dict[str, float]:
        """Run ``steps`` Adam steps on the residual; returns diagnostics.
        ``indices [steps, batch]`` fixes each step's minibatch rows (else
        they are drawn from the generator).  Installs nothing: ``apply``
        (or ``fit_and_apply``) does."""
        if self._count < self.batch_size:
            return {"fitted": 0.0, "count": float(self._count)}
        start = self.predictor._res
        if (self._pending or self._params is None
                or {k: v.shape for k, v in self._params.items()}
                != {k: v.shape for k, v in start.items()}):
            # A discarded fit's moments (or another architecture's) no
            # longer apply: Adam restarts from the installed weights.
            self._params = {k: torch.zeros_like(v, requires_grad=True) for k, v in start.items()}
            self._adam = torch.optim.Adam(list(self._params.values()), lr=self.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        with torch.no_grad():
            for k, v in start.items():
                self._params[k].copy_(v)
        xs, us, sn = self._buffers()
        if indices is None:
            indices = torch.randint(0, self._count, (steps, self.batch_size),
                                    generator=self._generator, device=self.device)
        indices = torch.as_tensor(indices, device=self.device)
        if tuple(indices.shape) != (steps, self.batch_size):
            raise ValueError(f"indices of shape {tuple(indices.shape)}, expected "
                             f"{(steps, self.batch_size)}")
        with torch.no_grad():
            loss_before = self._loss(self._params, xs, us, sn)
        for idx in indices:
            self._adam.zero_grad(set_to_none=True)
            with torch.enable_grad():
                pred = self._predict(self._params, xs[idx], us[idx])
                torch.mean((pred - sn[idx]) ** 2).backward()
            self._adam.step()
        with torch.no_grad():
            loss_after = self._loss(self._params, xs, us, sn)
            self._fitted_res = {k: v.detach().clone() for k, v in self._params.items()}
        self._pending = True
        return {"fitted": 1.0, "count": float(self._count),
                "loss_before": float(loss_before), "loss_after": float(loss_after)}

    def apply(self) -> None:
        """Install the last fit into the live predictor.  One-shot: a later
        bare ``apply`` does not re-install it over weights set otherwise."""
        if self._fitted_res is None:
            return
        self.predictor.set_residual(self._fitted_res)
        self._pending = False
        self._fitted_res = None

    def fit_and_apply(self, steps: int = 200, indices=None) -> Dict[str, float]:
        diag = self.fit(steps, indices)
        if diag.get("fitted"):
            self.apply()
        return diag

    # ---- evaluation ---------------------------------------------------------
    def one_step_mse(self, use_residual: bool = True) -> float:
        """Mean one-step prediction error over the recorded transitions."""
        if self._count == 0:
            return float("nan")
        xs, us, sn = self._buffers()
        with torch.no_grad():
            if use_residual:
                pred = self.predictor.single_step(xs, us, self.predictor.default_params())
            else:
                base = self.predictor.base
                pred = base.single_step(xs, us, base.default_params())
            return float(torch.mean((pred - sn) ** 2))
