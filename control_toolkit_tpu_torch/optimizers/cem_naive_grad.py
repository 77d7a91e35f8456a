"""CEM with one naive gradient step an outer iteration (Bharadhwaj et al.
2020's simple variant; counterpart of
control_toolkit_tpu/optimizers/cem_naive_grad.py).

Each outer iteration samples K sequences from the CEM Gaussian, clips
them, takes one SGD step on them along the gradient of the summed
trajectory cost (each rollout's gradient norm-clipped to
``gradmax_clip`` over its [H, U]), clips again, scores the moved
population and refits the Gaussian to its ``cem_best_k`` elites.  The
control is the refit mean's first action; sigma is clipped to
``[cem_stdev_min, 10.0]`` (the reference's own cap for this variant, not
plain CEM's 1e8) and both shift one step, the tails taking the initial
defaults.

The gradient and the cost come from ``Optimizer._make_grad_and_cost_only``:
K7 and K1 over the ODE (``ops/grad_cost_rollout.py``,
``ops/cost_rollout.py``), K8, K9 or K10 and their cost kernels over the
learned models, ``torch.autograd`` otherwise.  Each step is a draw per
outer iteration (``sample_draws``: the normals ``[K, H, U]``) followed by
a deterministic ``update(state, s, params, draws)``, an outer iteration
at a time (``iterate``).  Not ported (``NotImplementedError``, ROADMAP):
the policy warm start.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops.common import clip_by_norm, elite_indices
from control_toolkit_tpu_torch.optimizers.base import Optimizer, _not_ported
from control_toolkit_tpu_torch.optimizers.cem import CEMState, cem_shift_distribution, refit
from control_toolkit_tpu_torch.utils import registry

# The reference's sigma cap for its gradient CEM variants (plain CEM's is 1e8).
GRAD_CEM_STDEV_MAX = 10.0


@registry.optimizers.register("cem-naive-grad-tf")
@registry.optimizers.register("cem-naive-grad")
class CEMNaiveGradOptimizer(Optimizer):
    def __init__(
        self,
        *,
        cem_outer_it: int = 1,
        cem_initial_action_stdev: float = 0.5,
        cem_stdev_min: float = 0.1,
        cem_best_k: int = 40,
        learning_rate: float = 0.1,
        gradmax_clip: float = 10.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.cem_outer_it = int(cem_outer_it)
        self.cem_initial_action_stdev = float(cem_initial_action_stdev)
        self.cem_stdev_min = float(cem_stdev_min)
        self.cem_best_k = int(cem_best_k)
        if self.cem_best_k > self.num_rollouts:
            raise ValueError(
                f"cem_best_k={self.cem_best_k} exceeds num_rollouts={self.num_rollouts}"
            )
        self.learning_rate = float(learning_rate)
        self.gradmax_clip = float(gradmax_clip)

    def _init_state(self, generator):
        H, U = self.mpc_horizon, self.num_control_inputs
        u_mid = 0.5 * (self.action_low + self.action_high)
        return CEMState(
            generator=generator,
            dist_mue=u_mid.expand(1, H, U).to(torch.float32).clone(),
            stdev=torch.full((1, H, U), self.cem_initial_action_stdev, dtype=torch.float32,
                             device=self.device),
            count=0,
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
        )

    def _apply_policy_guess(self, state, plan):
        raise _not_ported("initial_guess_policy")

    def sample_draws(self, state: CEMState) -> list:
        """This step's draws, one per outer iteration: the normals
        ``[K, H, U]``."""
        shape = (self.num_rollouts, self.mpc_horizon, self.num_control_inputs)
        return [torch.randn(shape, generator=state.generator, dtype=torch.float32,
                            device=self.device) for _ in range(self.cem_outer_it)]

    def _make_step_fn(self):
        K, U = self.num_rollouts, self.num_control_inputs
        low, high = self.action_low, self.action_high
        best_k, lr, gclip = self.cem_best_k, self.learning_rate, self.gradmax_clip
        u_mid = 0.5 * (low + high)
        grad_fn, cost_only = self._make_grad_and_cost_only()
        want_Q = self.optimizer_logging

        def iterate(carry, s_tiled, u_prev, params, z):
            """One outer iteration from ``carry`` (``mue``, ``std``): the
            sample, its gradient step, the moved population's costs, the
            elites ``idx`` (best first) and the refit."""
            Q = torch.clamp(carry["mue"] + z * carry["std"], low, high)
            dQ = clip_by_norm(grad_fn(Q, s_tiled, u_prev, params), gclip, axes=(1, 2))
            Qn = torch.clamp(Q - lr * dQ, low, high)
            logged = {"Q_logged": Qn} if want_Q else {}
            if cost_only is not None:
                cost = cost_only(s_tiled, Qn, u_prev, params)
            else:
                cost, logged["rollout_trajectories_logged"] = self._rollout_and_cost(
                    s_tiled, Qn, u_prev, params)
            idx = elite_indices(cost, best_k)
            mue, std = refit(Qn[idx])
            return dict(carry, mue=mue, std=std, cost=cost, idx=idx, **logged)

        def update(state: CEMState, s, params, draws):
            if len(draws) != self.cem_outer_it:
                raise ValueError(f"{len(draws)} draws for {self.cem_outer_it} outer iterations")
            s_tiled = s[:1].expand(K, -1).contiguous()
            carry = {"mue": state.dist_mue, "std": state.stdev}
            for z in draws:
                carry = iterate(carry, s_tiled, state.u_prev, params, z)
            mue = carry["mue"]
            u = mue[0, 0, :]
            mue_s, std_s = cem_shift_distribution(mue, carry["std"], u_mid, self.cem_stdev_min,
                                                  self.cem_initial_action_stdev, U,
                                                  GRAD_CEM_STDEV_MAX)
            new_state = CEMState(generator=state.generator, dist_mue=mue_s, stdev=std_s,
                                 count=state.count + 1, u_prev=u)
            diag = {k: carry[k] for k in ("Q_logged", "rollout_trajectories_logged")
                    if k in carry}
            return u, new_state, dict(diag, J_logged=carry["cost"], u_nom=mue)

        self.iterate, self.update = iterate, update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
