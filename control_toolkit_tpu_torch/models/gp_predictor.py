"""Sparse Gaussian-process dynamics predictor (counterpart of
control_toolkit_tpu/models/gp_predictor.py).

The reference selects GP models by name ('SGP_30' in
Control_Toolkit_ASF_Template/config_controllers.yml:8).  This is a
subset-of-regressors sparse GP with an RBF kernel, one output head per
state-delta dimension: ``x' = x + (k(x̂, Z) @ alpha) * out_std + out_mean``
with ``x̂ = ([x, u] - in_mean) / in_std``.  The params ``{"gp": {Z, alpha,
lengthscales, variance, in_mean, in_std, out_mean, out_std}}`` are tensors
on the predictor's device; assigning a new dict to ``gp_params`` (a re-fit)
reaches the controller's next step with nothing rebuilt.  The rollout
kernels K14 and K10 (``ops/gp_rollout.py``, ``ops/gp_grad_cost_rollout.py``)
take the precomputed form of these tensors (``flatten_gp_weights``).

``fit_gp_dynamics`` is the JAX package's numpy float64 fit, copied
operation for operation, so both packages fit the same posterior from the
same data.  A checkpoint (``save``) is an npz of the eight arrays, the JAX
package's layout.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from control_toolkit_tpu_torch.models.dynamics import DYNAMICS
from control_toolkit_tpu_torch.models.predictors import Predictor, scan_rollout
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.device import place, resolve_device

logger = logging.getLogger(__name__)

GP_KEYS = ("Z", "alpha", "lengthscales", "variance", "in_mean", "in_std", "out_mean", "out_std")


def rbf(a: torch.Tensor, b: torch.Tensor, lengthscales: torch.Tensor,
        variance: torch.Tensor) -> torch.Tensor:
    """RBF kernel block: a [N, D], b [M, D] -> [N, M]."""
    an = a / lengthscales
    bn = b / lengthscales
    d2 = (torch.sum(an * an, -1, keepdim=True) - 2.0 * an @ bn.T
          + torch.sum(bn * bn, -1)[None, :])
    return variance * torch.exp(-0.5 * torch.maximum(d2, torch.zeros_like(d2)))


def fit_gp_dynamics(x: np.ndarray, u: np.ndarray, x_next: np.ndarray,
                    num_inducing: int = 256, noise: float = 1e-6, seed: int = 0,
                    lengthscale_scale: float = 3.0) -> Tuple[Dict[str, np.ndarray], float]:
    """Fit a sparse (projected-process) GP to state deltas.

    Returns (params as float32 numpy arrays, normalized MSE on the training
    set).  Lengthscales by the median heuristic per input dimension, widened
    by ``lengthscale_scale``; inducing points a random training subset.  The
    fit runs in numpy float64: the normal equations are too ill-conditioned
    for a float32 solve."""
    inp = np.concatenate([x, u], axis=-1).astype(np.float64)
    target = (x_next - x).astype(np.float64)
    in_mean, in_std = inp.mean(0), inp.std(0) + 1e-8
    t_mean, t_std = target.mean(0), target.std(0) + 1e-8
    Xn = (inp - in_mean) / in_std
    Yn = (target - t_mean) / t_std

    rng = np.random.default_rng(seed)
    M = min(num_inducing, Xn.shape[0])
    Z = Xn[rng.choice(Xn.shape[0], M, replace=False)]
    sub = Xn[rng.choice(Xn.shape[0], min(512, Xn.shape[0]), replace=False)]
    pd = np.abs(sub[:, None, :] - sub[None, :, :])
    ls = (np.median(pd, axis=(0, 1)) + 1e-3) * lengthscale_scale
    variance = 1.0

    def np_rbf(a, b):
        an = a / ls
        bn = b / ls
        d2 = ((an * an).sum(-1)[:, None] - 2.0 * an @ bn.T
              + (bn * bn).sum(-1)[None, :])
        return variance * np.exp(-0.5 * np.maximum(d2, 0.0))

    Kzz = np_rbf(Z, Z)
    Kzx = np_rbf(Z, Xn)
    # alpha = (noise*Kzz + Kzx Kxz)^-1 Kzx Y   (projected process, scaled)
    A = noise * Kzz + Kzx @ Kzx.T + 1e-8 * np.eye(M)
    alpha = np.linalg.solve(A, Kzx @ Yn)                  # [M, S]
    mse = float(np.mean((np_rbf(Xn, Z) @ alpha - Yn) ** 2))
    logger.info(f"GP dynamics fit: M={M}, normalized MSE {mse:.3e}")
    params = {"Z": Z, "alpha": alpha, "lengthscales": ls, "variance": np.float32(variance),
              "in_mean": in_mean, "in_std": in_std, "out_mean": t_mean, "out_std": t_std}
    return {k: np.asarray(v, np.float32) for k, v in params.items()}, mse


@registry.predictors.register("SGP")
@registry.predictors.register("gp")
class GPPredictor(Predictor):
    """Sparse-GP dynamics ``x_{t+1} = x_t + GP(x_t, u_t)`` on ``device``,
    from fitted ``params`` or a ``checkpoint`` npz."""

    def __init__(self, environment_name: str = "cartpole", dt: float = 0.02,
                 num_states: Optional[int] = None, num_control_inputs: Optional[int] = None,
                 params: Optional[Dict] = None, checkpoint: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.environment_name = environment_name.lower()
        if num_states is None or num_control_inputs is None:
            _, _, s_def, u_def = DYNAMICS[self.environment_name]
            num_states = s_def if num_states is None else num_states
            num_control_inputs = u_def if num_control_inputs is None else num_control_inputs
        self.num_states = int(num_states)
        self.num_control_inputs = int(num_control_inputs)
        self.dt = float(dt)
        self.device = resolve_device(device)
        if params is None and not checkpoint:
            raise ValueError("GPPredictor needs fitted params or a checkpoint "
                             "(fit with models.gp_predictor.fit_gp_dynamics)")
        if params is None:
            with np.load(checkpoint) as data:
                params = {k: data[k] for k in data.files}
            logger.info(f"loaded GP dynamics from {checkpoint}")
        self.gp_params = place(params, self.device)

    def default_params(self) -> Dict:
        return {"gp": self.gp_params}

    @property
    def single_step(self):
        def step(x, u, p):
            g = p["gp"]
            inp = (torch.cat([x, u], -1) - g["in_mean"]) / g["in_std"]
            k = rbf(inp, g["Z"], g["lengthscales"], g["variance"])
            return x + ((k @ g["alpha"]) * g["out_std"] + g["out_mean"])

        return step

    def rollout(self, s0, Q, params=None):
        p = self.default_params() if params is None else params
        return scan_rollout(self.single_step, s0, Q, p)

    def save(self, path) -> None:
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in self.gp_params.items()})
