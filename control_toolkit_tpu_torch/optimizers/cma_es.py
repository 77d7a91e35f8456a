"""CMA-ES: Covariance Matrix Adaptation Evolution Strategy over the
flattened plan ``x = Q.reshape(H*U)`` (counterpart of
control_toolkit_tpu/optimizers/cma_es.py; Hansen, arXiv:1604.00772).

A generation samples ``y = B diag(D) z`` from ``C = B diag(D)^2 B^T``
(``torch.linalg.eigh``; the diagonal of C in ``cma_diagonal`` mode,
sep-CMA-ES), repairs ``x = mean + sigma*y`` into the bounds, scores the
population by K1 (``ops/cost_rollout.py``) through
``Optimizer._make_cost_only`` (the trajectory rollout when logging is on),
then takes the rank-mu update from the ``cma_mu`` best with log-linear
weights, the rank-1 update from the evolution path ``p_c`` (with the
``h_sigma`` stall guard) and the cumulative step-size adaptation over the
conjugate path ``p_sigma`` in the ``C^{-1/2}`` metric.  The executed
control is the first action of the best evaluated row of the last
generation; at the control-step boundary the mean shifts one step (the
tail repeats the last action) while sigma, C and the paths carry over.

The generation is split so that tests can hold each half to the JAX
package: ``sample(carry, z, eig) -> X [K, N]`` and ``refit(carry, X,
idx, eig) -> carry'`` (``idx`` the ``cma_mu`` best rows, best first),
where ``eig = decompose(C)`` is the one
eigendecomposition a generation takes (``(D, B)``; ``sqrt(C)`` in
diagonal mode).  ``sample`` reads B's signs: an eigenvector may come back
from ``torch.linalg.eigh`` with the opposite sign from the JAX package's
(and from cuSOLVER's on the card), so the same ``z`` may give another
``y``.  ``refit`` reads only ``C^{-1/2} y_w = B (B^T y_w / D)``, which no
sign changes.  Each step is a draw per generation (``sample_draws``: the
normals ``[K - add_mean, N]``) followed by a deterministic ``update(state,
s, params, draws)``.  The generation and step counters are host ints, so
the ``h_sigma`` debias and the warmup trip count are host decisions.  The
policy warm start centres the search on the policy's plan
(``_apply_policy_guess``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.optimizers.base import Optimizer
from control_toolkit_tpu_torch.utils import registry


class CMAESState(NamedTuple):
    generator: torch.Generator
    mean: torch.Tensor     # [N] flattened plan, N = H*U
    sigma: torch.Tensor    # scalar step size
    C: torch.Tensor        # [N, N] covariance ([N] diagonal in sep-CMA mode)
    p_sigma: torch.Tensor  # [N] conjugate evolution path
    p_c: torch.Tensor      # [N] covariance evolution path
    gen: int               # host counter: generations since reset
    count: int             # host counter: control steps
    u_prev: torch.Tensor   # [U]


@registry.optimizers.register("cma-es-tf")
@registry.optimizers.register("cma-es")
class CMAESOptimizer(Optimizer):
    def __init__(
        self,
        *,
        cma_outer_it: int = 3,
        cma_mu: Optional[int] = None,
        cma_initial_step_size: float = 0.3,
        cma_step_size_min: float = 0.01,
        cma_step_size_max: float = 1.0e8,
        cma_diagonal: bool = False,
        cma_add_mean_sample: bool = True,
        warmup: bool = False,
        warmup_iterations: int = 50,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.cma_outer_it = int(cma_outer_it)
        self.sigma0 = float(cma_initial_step_size)
        self.sigma_min = float(cma_step_size_min)
        self.sigma_max = float(cma_step_size_max)
        self.diag = bool(cma_diagonal)
        self.add_mean = bool(cma_add_mean_sample)
        self.warmup = bool(warmup)
        self.warmup_iterations = int(warmup_iterations)
        self.mu = int(cma_mu) if cma_mu is not None else self.num_rollouts // 2
        if not (1 <= self.mu <= self.num_rollouts):
            raise ValueError(f"cma_mu={self.mu} must be in [1, num_rollouts={self.num_rollouts}]")
        if self.num_rollouts - int(self.add_mean) < 1:
            raise ValueError("num_rollouts leaves no room for fresh samples")

    def configure(self, num_states, num_control_inputs, dt=None, **kwargs):
        super().configure(num_states, num_control_inputs, dt=dt, **kwargs)
        if self.device.type == "cuda":
            # The refit's products are float32 matmuls: keep them in full
            # float32, as the JAX reference computes them (no TF32).
            torch.backends.cuda.matmul.allow_tf32 = False

    # ---- strategy constants (N = H*U is known after configure) ------------
    def _constants(self):
        """``(N, w [mu] float32, mu_eff, c_s, d_s, c_c, c_1, c_mu, chiN)``:
        the weights normalized in float32, as the JAX package computes
        them, so that mu_eff and every constant derived from it agree."""
        N = self.mpc_horizon * self.num_control_inputs
        mu = self.mu
        w = torch.tensor([math.log(mu + 0.5) - math.log(i + 1.0) for i in range(mu)],
                         dtype=torch.float32)
        w = w / torch.sum(w)
        mu_eff = float(1.0 / torch.sum(w * w))
        c_s = (mu_eff + 2.0) / (N + mu_eff + 5.0)
        d_s = 1.0 + 2.0 * max(0.0, math.sqrt((mu_eff - 1.0) / (N + 1.0)) - 1.0) + c_s
        c_c = (4.0 + mu_eff / N) / (N + 4.0 + 2.0 * mu_eff / N)
        c_1 = 2.0 / ((N + 1.3) ** 2 + mu_eff)
        c_mu = min(1.0 - c_1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((N + 2.0) ** 2 + mu_eff))
        if self.diag:
            # sep-CMA (Ros & Hansen 2008): N parameters, not N(N+1)/2, so the
            # learning rates speed up ~(N+2)/3.
            scale = (N + 2.0) / 3.0
            c_1 = min(1.0, c_1 * scale)
            c_mu = min(1.0 - c_1, c_mu * scale)
        chiN = math.sqrt(N) * (1.0 - 1.0 / (4.0 * N) + 1.0 / (21.0 * N * N))
        return N, w.to(self.device), mu_eff, c_s, d_s, c_c, c_1, c_mu, chiN

    def _init_state(self, generator):
        H, U = self.mpc_horizon, self.num_control_inputs
        N = H * U
        u_mid = (0.5 * (self.action_low + self.action_high)).to(torch.float32)
        C = (torch.ones(N, dtype=torch.float32, device=self.device) if self.diag
             else torch.eye(N, dtype=torch.float32, device=self.device))
        zeros = torch.zeros(N, dtype=torch.float32, device=self.device)
        return CMAESState(
            generator=generator, mean=u_mid.repeat(H), C=C,
            sigma=torch.tensor(self.sigma0, dtype=torch.float32, device=self.device),
            p_sigma=zeros, p_c=zeros.clone(), gen=0, count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def _apply_policy_guess(self, state, plan):
        """The search distribution centred on a heuristic-policy rollout
        (JAX ``cma_es.py:150``)."""
        return state._replace(mean=plan.to(torch.float32).reshape(-1))

    def trip_count(self, count: int) -> int:
        return self.warmup_iterations if self.warmup and count == 0 else self.cma_outer_it

    def sample_draws(self, state: CMAESState) -> list:
        """This step's draws, one per generation: the normals
        ``[K - add_mean, N]``."""
        shape = (self.num_rollouts - int(self.add_mean),
                 self.mpc_horizon * self.num_control_inputs)
        return [torch.randn(shape, generator=state.generator, dtype=torch.float32,
                            device=self.device) for _ in range(self.trip_count(state.count))]

    def _make_step_fn(self):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        N, w, mu_eff, c_s, d_s, c_c, c_1, c_mu, chiN = self._constants()
        mu, add_mean, diag = self.mu, self.add_mean, self.diag
        low_n = self.action_low.to(torch.float32).repeat(H)
        high_n = self.action_high.to(torch.float32).repeat(H)
        cost_only = None if self.optimizer_logging else self._make_cost_only()
        want_Q = self.optimizer_logging
        ps_scale = math.sqrt(c_s * (2.0 - c_s) * mu_eff)
        pc_scale = math.sqrt(c_c * (2.0 - c_c) * mu_eff)
        hsig_at = 1.4 + 2.0 / (N + 1.0)

        def decompose(C):
            """The generation's decomposition: ``sqrt(C)`` (diagonal mode)
            or ``(D, B)`` with ``C = B diag(D)^2 B^T``."""
            if diag:
                return torch.sqrt(C)
            evals, B = torch.linalg.eigh(0.5 * (C + C.T))
            return torch.sqrt(torch.clamp_min(evals, 1e-12)), B

        def sample(carry, z, eig):
            """``X [K, N]``: ``mean + sigma * y`` (and the mean row),
            clipped into the bounds (repair)."""
            if diag:
                y = z * eig
            else:
                D, B = eig
                y = (z * D) @ B.T                                     # y_i = B D z_i
            x = carry["mean"] + carry["sigma"] * y
            if add_mean:
                x = torch.cat([x, carry["mean"][None]], dim=0)
            return torch.clamp(x, low_n, high_n)

        def refit(carry, X, idx, eig):
            """The generation's update from the evaluated population ``X``
            and its ``mu`` best rows ``idx``, best first (reads ``eig`` only
            through C^{-1/2})."""
            mean, sigma, C = carry["mean"], carry["sigma"], carry["C"]
            Ysel = (X[idx] - mean) / sigma                            # the repaired steps
            y_w = w @ Ysel
            if diag:
                invsqrt_yw = y_w / eig
            else:
                D, B = eig
                invsqrt_yw = B @ ((B.T @ y_w) / D)
            ps = (1.0 - c_s) * carry["p_sigma"] + ps_scale * invsqrt_yw
            gen1 = carry["gen"] + 1
            ps_norm = torch.linalg.vector_norm(ps)
            # h_sigma stall guard (tutorial eq. 45); the debias in float32 on
            # the host, as the JAX package casts its counter.
            debias = float(np.sqrt(np.float32(1.0) - np.float32(1.0 - c_s)
                                   ** np.float32(2.0 * gen1)))
            hsig = (ps_norm / max(debias, 1e-12) / chiN < hsig_at).to(torch.float32)
            pc = (1.0 - c_c) * carry["p_c"] + hsig * pc_scale * y_w
            if diag:
                rank1, rankmu = pc * pc, w @ (Ysel * Ysel)
            else:
                rank1, rankmu = torch.outer(pc, pc), Ysel.T @ (w[:, None] * Ysel)
            C_new = ((1.0 - c_1 - c_mu) * C + c_1 * (rank1 + (1.0 - hsig) * c_c * (2.0 - c_c) * C)
                     + c_mu * rankmu)
            if diag:
                C_new = torch.clamp_min(C_new, 1e-12)
            sigma_new = torch.clamp(sigma * torch.exp((c_s / d_s) * (ps_norm / chiN - 1.0)),
                                    self.sigma_min, self.sigma_max)
            return dict(carry, mean=mean + sigma * y_w, sigma=sigma_new, C=C_new, p_sigma=ps,
                        p_c=pc, gen=gen1, best=X[idx[0]].reshape(H, U))

        def update(state: CMAESState, s, params, draws):
            if len(draws) != self.trip_count(state.count):
                raise ValueError(f"step {state.count}: {len(draws)} draws for "
                                 f"{self.trip_count(state.count)} generations")
            s_tiled = s[:1].expand(K, -1).contiguous()
            carry = {"mean": state.mean, "sigma": state.sigma, "C": state.C,
                     "p_sigma": state.p_sigma, "p_c": state.p_c, "gen": state.gen}
            logged = {}
            for z in draws:
                eig = decompose(carry["C"])
                X = sample(carry, z, eig)
                Q = X.reshape(K, H, U)
                if cost_only is not None:
                    cost = cost_only(s_tiled, Q, state.u_prev, params)
                else:
                    cost, logged["rollout_trajectories_logged"] = self._rollout_and_cost(
                        s_tiled, Q, state.u_prev, params)
                if want_Q:
                    logged["Q_logged"] = Q
                carry = refit(carry, X, elite_indices(cost, mu), eig)
                carry["cost"] = cost
            u = carry["best"][0, :]
            m2 = carry["mean"].reshape(H, U)
            new_state = CMAESState(
                generator=state.generator,
                mean=torch.cat([m2[1:], m2[-1:]], dim=0).reshape(N), sigma=carry["sigma"],
                C=carry["C"], p_sigma=carry["p_sigma"], p_c=carry["p_c"], gen=carry["gen"],
                count=state.count + 1, u_prev=u)
            diag_out = {"J_logged": carry["cost"], "u_nom": carry["best"][None], **logged}
            return u, new_state, diag_out

        self.decompose, self.sample, self.refit, self.update = decompose, sample, refit, update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
