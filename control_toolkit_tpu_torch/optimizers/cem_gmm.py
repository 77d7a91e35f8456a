"""CEM with a 2-component Gaussian-mixture sampling distribution
(counterpart of control_toolkit_tpu/optimizers/cem_gmm.py).

Each outer iteration draws every rollout's mixture component, samples K
sequences from its component's diagonal Gaussian, clips them, scores them
by K1 (``ops/cost_rollout.py``) through ``Optimizer._make_cost_only`` (the
trajectory rollout when logging is on), takes the ``cem_best_k`` elites,
clusters them to the Frobenius-nearest of the two best (elite 0 seeds
cluster 0, elite 1 cluster 1, ties to cluster 0) and refits each component
to its cluster by masked moments (the population std, an empty cluster
guarded by ``max(count, 1)``); the mixture weight is the cluster fraction.
After the iterations both components shift one step in time (the tails
repeat the last step) and the control is the best elite's first action.

Each step is a draw per outer iteration (``sample_draws``: the Gumbel
noise ``[K, 2]`` of the component draw and the normals ``[K, H, U]``)
followed by a deterministic ``update(state, s, params, draws)``, an
outer iteration at a time (``iterate``).  The component of rollout k is
``argmax(gumbel[k] + log(probs + 1e-9))``, the Gumbel-max form of the JAX
package's ``jax.random.categorical``, so tests can feed both packages the
same random numbers.  Not ported (``NotImplementedError``, ROADMAP): the
policy warm start.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.optimizers.base import Optimizer, _not_ported
from control_toolkit_tpu_torch.optimizers.cem import cem_base_carry, cem_diag
from control_toolkit_tpu_torch.utils import registry


class CEMGMMState(NamedTuple):
    generator: torch.Generator
    comp_mue: torch.Tensor   # [2, H, U]
    comp_std: torch.Tensor   # [2, H, U]
    mix_probs: torch.Tensor  # [2]
    u_prev: torch.Tensor     # [U]


def _masked_moments(x: torch.Tensor, mask: torch.Tensor):
    """Mean and population std of the rows ``x[i]`` where ``mask[i]``
    (``x [k, H, U]``, ``mask [k]`` bool), an empty cluster guarded by
    ``max(count, 1)``: ``([H, U], [H, U])``."""
    w = mask.to(torch.float32)
    count = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.einsum("k,khu->hu", w, x) / count
    var = torch.einsum("k,khu->hu", w, (x - mean) ** 2) / count
    return mean, torch.sqrt(var)


def gmm_cluster_refit(elite_Q: torch.Tensor, std_min: float):
    """Cluster the elites (``[k, H, U]``, best first) to the nearest of the
    two best by Frobenius distance and refit both components: elite 0 to
    cluster 0, elite 1 to cluster 1, a tie to cluster 0; the mixture weight
    is the cluster fraction.  Returns ``(mue [2, H, U], std [2, H, U] in
    [std_min, 1e4], probs [2])``."""
    best_k = elite_Q.shape[0]
    d0 = torch.sqrt(torch.sum((elite_Q - elite_Q[0]) ** 2, dim=(1, 2)))
    d1 = torch.sqrt(torch.sum((elite_Q - elite_Q[1]) ** 2, dim=(1, 2)))
    to_c1 = d1 < d0
    to_c1[0], to_c1[1] = False, True
    m0, s0 = _masked_moments(elite_Q, ~to_c1)
    m1, s1 = _masked_moments(elite_Q, to_c1)
    prob0 = torch.sum((~to_c1).to(torch.float32)) / best_k
    std = torch.stack([torch.clamp(s0, std_min, 1.0e4), torch.clamp(s1, std_min, 1.0e4)])
    return torch.stack([m0, m1]), std, torch.stack([prob0, 1.0 - prob0])


@registry.optimizers.register("cem-gmm-tf")
@registry.optimizers.register("cem-gmm")
class CEMGMMOptimizer(Optimizer):
    def __init__(
        self,
        *,
        cem_outer_it: int = 3,
        cem_initial_action_stdev: float = 0.5,
        cem_stdev_min: float = 0.01,
        cem_best_k: int = 40,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if cem_best_k < 2:
            raise ValueError("cem-gmm needs cem_best_k >= 2 (two cluster seeds)")
        self.cem_outer_it = int(cem_outer_it)
        self.cem_initial_action_stdev = float(cem_initial_action_stdev)
        self.cem_stdev_min = float(cem_stdev_min)
        self.cem_best_k = int(cem_best_k)
        if self.cem_best_k > self.num_rollouts:
            raise ValueError(
                f"cem_best_k={self.cem_best_k} exceeds num_rollouts={self.num_rollouts}"
            )

    def _apply_policy_guess(self, state, plan):
        raise _not_ported("initial_guess_policy")

    def _init_state(self, generator):
        H, U = self.mpc_horizon, self.num_control_inputs
        u_mid = (0.5 * (self.action_low + self.action_high)).to(torch.float32)
        return CEMGMMState(
            generator=generator,
            comp_mue=u_mid.expand(2, H, U).clone(),
            comp_std=torch.full((2, H, U), self.cem_initial_action_stdev, dtype=torch.float32,
                                device=self.device),
            mix_probs=torch.tensor([0.5, 0.5], dtype=torch.float32, device=self.device),
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def sample_draws(self, state: CEMGMMState) -> list:
        """This step's draws, one per outer iteration: the component draw's
        Gumbel noise ``[K, 2]`` (``-log`` of exponentials) and the normals
        ``[K, H, U]``."""
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        g = state.generator
        return [(-torch.log(torch.empty((K, 2), dtype=torch.float32, device=self.device)
                            .exponential_(generator=g)),
                 torch.randn((K, H, U), generator=g, dtype=torch.float32, device=self.device))
                for _ in range(self.cem_outer_it)]

    def _make_step_fn(self):
        K, H, U = self.num_rollouts, self.mpc_horizon, self.num_control_inputs
        low, high = self.action_low, self.action_high
        best_k, std_min = self.cem_best_k, self.cem_stdev_min
        cost_only = None if self.optimizer_logging else self._make_cost_only()
        want_Q = self.optimizer_logging

        def iterate(carry, s_tiled, u_prev, params, draw):
            """One outer iteration from ``carry`` (``mue``, ``std``,
            ``probs``): the population, its costs, the elites ``idx`` (best
            first) and the refit components."""
            gumbel, z = draw
            mue, std = carry["mue"], carry["std"]
            comp = torch.argmax(gumbel + torch.log(carry["probs"] + 1e-9), dim=1)   # [K]
            Q = torch.clamp(mue[comp] + z * std[comp], low, high)
            logged = {"Q": Q} if want_Q else {}
            if cost_only is not None:
                cost = cost_only(s_tiled, Q, u_prev, params)
            else:
                cost, logged["traj"] = self._rollout_and_cost(s_tiled, Q, u_prev, params)
            idx = elite_indices(cost, best_k)
            elite_Q = Q[idx]
            mue, std, probs = gmm_cluster_refit(elite_Q, std_min)
            return dict(carry, mue=mue, std=std, probs=probs, elite0=elite_Q[0], cost=cost,
                        idx=idx, **logged)

        def update(state: CEMGMMState, s, params, draws):
            if len(draws) != self.cem_outer_it:
                raise ValueError(f"{len(draws)} draws for {self.cem_outer_it} outer iterations")
            s_tiled = s[:1].expand(K, -1).contiguous()
            carry = cem_base_carry(state.comp_mue, state.comp_std, K, H, U, self.num_states,
                                   want_Q, cost_only is None)
            carry["probs"] = state.mix_probs
            for draw in draws:
                carry = iterate(carry, s_tiled, state.u_prev, params, draw)
            u = carry["elite0"][0, :]
            mue, std = carry["mue"], carry["std"]
            new_state = CEMGMMState(
                generator=state.generator,
                comp_mue=torch.cat([mue[:, 1:, :], mue[:, -1:, :]], dim=1),
                comp_std=torch.cat([std[:, 1:, :], std[:, -1:, :]], dim=1),
                mix_probs=carry["probs"], u_prev=u)
            return u, new_state, cem_diag(carry, want_Q, cost_only is None)

        self.iterate, self.update = iterate, update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
