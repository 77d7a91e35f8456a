"""Dynamics predictors (counterpart of control_toolkit_tpu/models/predictors.py).

A predictor holds a rollout function ``rollout(s0 [B,S], Q [B,H,U],
params) -> [B,H+1,S]``; the horizon is a Python loop (``scan_rollout``).
Ported: the ``"ODE[:integrator[:substeps]]"`` predictor, the learned
MLP/GRU/LSTM predictors (``models/neural_predictor.py``), the residual
``"ODE+res"`` (``models/residual_predictor.py``) and the sparse-GP
``"SGP_<M>"`` (``models/gp_predictor.py``) and the PETS ensemble
``"ensemble:<net>:<E>"`` (``models/ensemble_predictor.py``); a ``fast``
option among an ODE spec's (``"ODE:rk4:1:fast"``, ``"ODE+res:rk4:1:fast"``)
swaps the plant for its polynomial-trig ``.fast`` variant.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import torch

from control_toolkit_tpu_torch.models.dynamics import DYNAMICS, DynamicsFn
from control_toolkit_tpu_torch.utils import registry

logger = logging.getLogger(__name__)


def euler_step(f: DynamicsFn, x, u, dt, p):
    return x + dt * f(x, u, p)


def rk4_step(f: DynamicsFn, x, u, dt, p):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * dt * k1, u, p)
    k3 = f(x + 0.5 * dt * k2, u, p)
    k4 = f(x + dt * k3, u, p)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


INTEGRATORS = {"euler": euler_step, "rk4": rk4_step}


def make_ode_rollout(
    dynamics: DynamicsFn, dt: float, integrator: str = "rk4", intermediate_steps: int = 1
) -> Callable:
    """Build ``rollout(s0 [B,S], Q [B,H,U], params) -> [B,H+1,S]`` with
    ``rollout.single_step`` exposed for the fused cost rollouts."""
    step_fn = INTEGRATORS[integrator]
    sub_dt = dt / intermediate_steps

    def single_step(x, u, params):
        for _ in range(intermediate_steps):
            x = step_fn(dynamics, x, u, sub_dt, params)
        return x

    def rollout(s0: torch.Tensor, Q: torch.Tensor, params: Dict) -> torch.Tensor:
        return scan_rollout(single_step, s0, Q, params)

    rollout.single_step = single_step
    return rollout


def scan_rollout(step, s0: torch.Tensor, Q: torch.Tensor, params) -> torch.Tensor:
    """Horizon rollout of ``step(x [B,S], u [B,U], params) -> [B,S]``:
    [B,S] x [B,H,U] -> [B,H+1,S] with s0 prepended."""
    xs = [s0]
    x = s0
    for h in range(Q.shape[1]):
        x = step(x, Q[:, h, :], params)
        xs.append(x)
    return torch.stack(xs, dim=1)


class Predictor:
    """Base predictor: a pure rollout."""

    num_states: int
    num_control_inputs: int

    def rollout(self, s0, Q, params: Optional[Dict] = None) -> torch.Tensor:
        raise NotImplementedError

    def predict_core(self, s0, Q, params=None):
        return self.rollout(s0, Q, params)

    def update(self, s, Q0, params=None) -> None:
        """Advance internal (RNN) state with the applied control; a no-op
        for stateless predictors."""

    def copy(self) -> "Predictor":
        return self

    def default_params(self) -> Dict:
        return {}

    @property
    def single_step(self):
        return None

    @property
    def is_stateful(self) -> bool:
        return False


@registry.predictors.register("ODE")
class ODEPredictor(Predictor):
    """ODE-integrator predictor over a named built-in dynamics model.

    ``environment_name`` is kept (None for custom dynamics): the rollout
    kernels read it, with ``fast_math``, to pick the device plant
    (``ops/kernels.py:plant_key``).  ``fast_math`` swaps the dynamics for
    their ``.fast`` variant (polynomial trig, ``ops/fastmath.py``), so the
    scan path and every kernel see the same numerics; a plant without one
    keeps exact trig, with a warning.
    """

    def __init__(
        self,
        environment_name: str = "cartpole",
        dt: float = 0.02,
        integrator: str = "rk4",
        intermediate_steps: int = 1,
        dynamics: Optional[DynamicsFn] = None,
        num_states: Optional[int] = None,
        num_control_inputs: Optional[int] = None,
        params: Optional[Dict] = None,
        fast_math: bool = False,
    ):
        if dynamics is not None:
            if num_states is None or num_control_inputs is None:
                raise ValueError("custom dynamics needs num_states/num_control_inputs")
            self.environment_name = None
            self.dynamics = dynamics
            self._defaults = dict(params or {})
            self.num_states = num_states
            self.num_control_inputs = num_control_inputs
        else:
            key = environment_name.lower()
            if key not in DYNAMICS:
                raise KeyError(
                    f"No built-in dynamics for environment {environment_name!r}; "
                    f"available: {sorted(DYNAMICS)}"
                )
            fn, defaults, n_s, n_u = DYNAMICS[key]
            self.environment_name = key
            self.dynamics = fn
            self._defaults = dict(defaults)
            if params:
                self._defaults.update(params)
            self.num_states = n_s
            self.num_control_inputs = n_u
        self.fast_math = bool(fast_math)
        if self.fast_math:
            fast = getattr(self.dynamics, "fast", None)
            if fast is not None:
                self.dynamics = fast
            else:
                logger.warning("fast_math requested but dynamics has no .fast variant; "
                               "using exact trig")
        self.dt = float(dt)
        self.integrator = integrator
        self.intermediate_steps = int(intermediate_steps)
        self.rollout_fn = make_ode_rollout(
            self.dynamics, self.dt, integrator, self.intermediate_steps
        )

    def default_params(self) -> Dict:
        return dict(self._defaults)

    def rollout(self, s0, Q, params=None):
        p = self._defaults if params is None else params
        return self.rollout_fn(s0, Q, p)

    @property
    def single_step(self):
        return self.rollout_fn.single_step


class PredictorWrapper:
    """Deferred-configuration predictor resolver.  Spec grammar so far:
    ``"ODE"`` / ``"ODE_v0"`` (rk4), ``"ODE:euler"``, ``"ODE:rk4:2"``
    (integrator / substeps); ``"neural:<net>[:<path>][:bf16]"`` and the
    bare net name ``"<net>[:<path>][:bf16]"`` (``mlp-…``, ``GRU-…``,
    ``LSTM-…``), the checkpoint being ``<path>/<net>.npz``;
    ``"ODE+res[:integrator[:substeps]]"``, either with ``:fast`` among its
    options (polynomial trig); ``"SGP_<M>[:<checkpoint.npz>]"``
    and ``"gp"``; ``"ensemble:<net>:<E>[:<path>][:ts1][:prob]"``, the
    checkpoint being ``<path>/ensemble-<net>-x<E>.npz``.  ``device`` is where
    a learned predictor keeps its weights and hidden state."""

    def __init__(self):
        self.predictor: Optional[Predictor] = None
        self.num_states: Optional[int] = None
        self.num_control_inputs: Optional[int] = None
        self._spec: Optional[str] = None

    def configure(
        self,
        batch_size: Optional[int] = None,
        horizon: Optional[int] = None,
        dt: float = 0.02,
        predictor_specification: str = "ODE",
        environment_name: str = "cartpole",
        variable_parameters=None,
        device=None,
        **kwargs,
    ) -> None:
        self._spec = predictor_specification or "ODE"
        spec_parts = self._spec.split(":")
        head = spec_parts[0]
        neural_opts = None
        if head == "neural" and len(spec_parts) > 1:
            net_name, neural_opts = spec_parts[1], list(spec_parts[2:])
        elif head.lower().startswith(("gru", "lstm", "mlp")):
            net_name, neural_opts = head, list(spec_parts[1:])
        if neural_opts is not None:
            from control_toolkit_tpu_torch.models.neural_predictor import NeuralPredictor

            if neural_opts and neural_opts[-1] in ("bf16", "bfloat16", "f32", "float32"):
                kwargs.setdefault("compute_dtype", neural_opts.pop())
            self.predictor = NeuralPredictor(
                environment_name=environment_name, dt=dt, net_name=net_name,
                path_to_models=neural_opts[0] if neural_opts else None, device=device,
                **kwargs,
            )
        elif head == "ensemble" and len(spec_parts) > 1:
            # "ensemble:<net>:<E>[:<path>][:ts1][:prob]" (E defaults to 5):
            # PETS trajectory sampling over a bootstrap ensemble.
            from control_toolkit_tpu_torch.models.ensemble_predictor import (
                EnsemblePredictor,
            )

            opts = []
            for o in spec_parts[2:]:
                if o.lower() in ("ts1", "ts-1"):
                    kwargs.setdefault("ts", "1")
                elif o.lower() in ("prob", "pe"):
                    kwargs.setdefault("probabilistic", True)
                else:
                    opts.append(o)
            n_members = int(opts.pop(0)) if opts and opts[0].isdigit() else 5
            self.predictor = EnsemblePredictor(
                environment_name=environment_name, dt=dt, net_name=spec_parts[1],
                n_members=n_members, path_to_models=opts[0] if opts else None,
                device=device, **kwargs,
            )
        elif head in ("ODE", "ODE_v0", "ODE+res"):
            # "ODE[+res][:integrator[:substeps]][:fast]"; "+res" adds the
            # learned MLP residual (models/residual_predictor.py, hiddens via
            # kwargs); "fast" anywhere among the options sets fast_math.
            opts = list(spec_parts[1:])
            fast_math = "fast" in opts
            opts = [o for o in opts if o != "fast"]
            ode_kwargs = dict(
                environment_name=environment_name,
                dt=dt,
                integrator=opts[0] if len(opts) > 0 else "rk4",
                intermediate_steps=int(opts[1]) if len(opts) > 1 else 1,
                fast_math=fast_math,
                **kwargs,
            )
            if head == "ODE+res":
                from control_toolkit_tpu_torch.models.residual_predictor import (
                    ResidualPredictor,
                )

                self.predictor = ResidualPredictor(device=device, **ode_kwargs)
            else:
                self.predictor = ODEPredictor(**ode_kwargs)
        elif head.lower().startswith("sgp") or head.lower() == "gp":
            # "SGP_<M>[:<checkpoint.npz>]" (reference style 'SGP_30') or "gp";
            # the spec's path wins over a checkpoint kwarg.
            from control_toolkit_tpu_torch.models.gp_predictor import GPPredictor

            kw_ckpt = kwargs.pop("checkpoint", None)
            self.predictor = GPPredictor(
                environment_name=environment_name, dt=dt, device=device,
                checkpoint=spec_parts[1] if len(spec_parts) > 1 else kw_ckpt, **kwargs,
            )
        else:
            raise KeyError(
                f"Unknown or not yet ported predictor specification {self._spec!r}"
            )
        self.num_states = self.predictor.num_states
        self.num_control_inputs = self.predictor.num_control_inputs

    def default_params(self) -> Dict:
        return self.predictor.default_params() if self.predictor else {}

    def rollout(self, s0, Q, params=None):
        return self.predictor.rollout(s0, Q, params)

    def predict_core(self, s0, Q, params=None):
        return self.predictor.rollout(s0, Q, params)

    def update(self, s, Q0, params=None):
        return self.predictor.update(s, Q0, params)

    @property
    def single_step(self):
        return self.predictor.single_step if self.predictor else None

    @property
    def is_stateful(self) -> bool:
        return bool(self.predictor) and self.predictor.is_stateful

    def copy(self) -> "PredictorWrapper":
        new = PredictorWrapper()
        if self.predictor is not None:
            new.predictor = self.predictor.copy()
            new.num_states = self.num_states
            new.num_control_inputs = self.num_control_inputs
            new._spec = self._spec
        return new
