"""MPPI-var: MPPI with an adaptive per-input sampling stdev (counterpart
of control_toolkit_tpu/optimizers/mppi_var.py).

The sampling stdev is a state variable ``sigma [U]``, initialized at
``SQRTRHOINV_mc/sqrt(dt)`` clamped into ``[STDEV_min, STDEV_max]``.  Each
tick runs the MPPI update (``LBD_mc``, ``NU_mc``, ``R``, ``cc_weight``) on
the raw normals ``eps`` scaled by sigma, then sigma takes one
score-function step on the expected trajectory cost with the population
mean as baseline:

    grad_j = mean_k[(S_k - mean S) * (sum_p eps_kpj^2 - P)] / sigma_j,

norm-clipped to ``max_grad_norm``, scaled by ``LR`` and clamped into the
bounds.  ``LR = 0`` leaves sigma fixed and the step is MPPI's.

Each step is a draw (``sample_noise``: the raw normals, unscaled; the
MPPI step's own draw is pre-scaled) followed by a deterministic
``update(state, s, params, eps_raw)``.  Two update paths, chosen as
MPPI chooses them (``fully_fused`` is forced off: K3's update is plain
MPPI's):

* semi-fused (default): ``eps_raw [P, U, K]`` scaled by ``sigma[None, :,
  None]`` goes through MPPI's semi-fused update, K2
  (``ops/mppi_cost.py``; its emit_terminal form under a learned value
  terminal, V joining the costs before the weights and the adaptation);
* modular: ``eps_raw [K, P, U]``, interpolated and clipped in torch,
  scored by K1 through ``Optimizer._make_cost_only`` (or a learned
  model's kernel; the trajectory rollout when logging is on).

The batched-mpc controller's B-session step (``_make_batched_var_step``)
is MPPI's K4 step on each slot's raw draws scaled by its own sigma, with
each session's adaptation over its ``[K]`` costs.
``calculate_optimal_trajectory`` takes the modular path (JAX
``mppi_var.py:243``), whose diagnostics carry the nominal plan's replay
through the predictor; the policy warm start is MPPI's hook (its
``_replace`` keeps the stdev).
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from control_toolkit_tpu_torch.optimizers.mppi import MPPIOptimizer, MPPIState
from control_toolkit_tpu_torch.utils import registry

logger = logging.getLogger(__name__)


class MPPIVarState(NamedTuple):
    generator: torch.Generator  # noise source
    u_nom: torch.Tensor         # [1, H, U] nominal plan
    u_prev: torch.Tensor        # [U] last applied control
    stdev: torch.Tensor         # [U] adaptive per-input sampling stdev


@registry.optimizers.register("mppi-var-tf")
@registry.optimizers.register("mppi-var")
class MPPIVarOptimizer(MPPIOptimizer):
    def __init__(
        self,
        *,
        cc_weight: float = 1.0,
        R: float = 1.0,
        LBD_mc: float = 10.0,
        SQRTRHOINV_mc: float = 0.002,
        NU_mc: float = 20.0,
        LR: float = 1000.0,
        STDEV_min: float = 0.01,
        STDEV_max: float = 10.0,
        max_grad_norm: float = 100000.0,
        period_interpolation_inducing_points: int = 10,
        **kwargs,
    ):
        # The schema carries MPPI's knobs with the _mc suffix; the plain keys
        # would collide with the forwarding below, and the fused update and
        # Adam refinement options have no mppi-var step.
        for k in ("LBD", "NU", "SQRTRHOINV", "fully_fused", "optim_steps", "bounded_update"):
            if k in kwargs:
                logger.warning(f"mppi-var ignores config key {k!r} (use the _mc-suffixed schema; "
                               "optim_steps/bounded_update/fully_fused are plain-MPPI options)")
                kwargs.pop(k)
        super().__init__(cc_weight=cc_weight, R=R, LBD=LBD_mc, NU=NU_mc,
                         SQRTRHOINV=SQRTRHOINV_mc,
                         period_interpolation_inducing_points=period_interpolation_inducing_points,
                         fully_fused=False, **kwargs)
        self.LR = float(LR)
        self.STDEV_min = float(STDEV_min)
        self.STDEV_max = float(STDEV_max)
        self.max_grad_norm = float(max_grad_norm)

    def _init_state(self, generator):
        mppi = super()._init_state(generator)
        # The [STDEV_min, STDEV_max] contract holds from the first sample.
        stdev = torch.clamp(torch.full((self.num_control_inputs,), self.SQRTRHODTINV,
                                       dtype=torch.float32, device=self.device),
                            self.STDEV_min, self.STDEV_max)
        return MPPIVarState(generator, mppi.u_nom, mppi.u_prev, stdev)

    def _uses_semi_fused(self) -> bool:
        """MPPI's semi-fused gate and no optimal trajectory (JAX
        ``mppi_var.py:243``): that option takes the modular path."""
        return super()._uses_semi_fused() and not self.calculate_optimal_trajectory

    def _apply_stdev_update(self, stdev, grad):
        """The sigma update's tail: norm-clip the gradient over the inputs,
        take the LR step, clamp into the bounds.  ``stdev`` and ``grad`` are
        ``[U]``, or a fleet's ``[B, U]`` (each session clipped by its own
        norm)."""
        gnorm = torch.sqrt(torch.sum(grad**2, dim=-1, keepdim=True))
        grad = grad * torch.clamp_max(self.max_grad_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
        return torch.clamp(stdev - self.LR * grad, self.STDEV_min, self.STDEV_max)

    def _stdev_step(self, stdev, costs, sq_sum, P: int):
        """One clipped score-function step on sigma, every path's: ``costs
        [..., K]`` the trajectory costs (the correction and a value terminal
        included), ``sq_sum [..., K, U]`` each rollout's raw normals squared
        and summed over the P inducing points, ``stdev [..., U]``; LR = 0
        leaves sigma as it is."""
        advantage = costs - torch.mean(costs, dim=-1, keepdim=True)
        grad = torch.mean(advantage[..., None] * (sq_sum - P) / stdev[..., None, :], dim=-2)
        return self._apply_stdev_update(stdev, grad)

    def sample_noise(self, state: MPPIVarState) -> torch.Tensor:
        """This step's draw, the raw normals (unscaled): ``[P, U, K]`` for
        the semi-fused update, ``[K, P, U]`` for the modular one."""
        return torch.randn(self._noise_shape, generator=state.generator, dtype=torch.float32,
                           device=self.device)

    def _make_step_fn(self):
        """MPPI's update of the path MPPI would take (semi-fused: K2, or its
        emit form under a value terminal; modular: K1 through
        ``_make_cost_only``) on the sigma-scaled raw draw, then the sigma
        step over its costs."""
        K, U = self.num_rollouts, self.num_control_inputs
        P = self.interp.number_of_interpolation_inducing_points
        if self._uses_semi_fused():
            self._noise_shape = (P, U, K)
            mppi_update = self._make_semi_fused_update()

            def scaled(eps_raw, stdev):
                return eps_raw * stdev[None, :, None]

            def sq_sum(eps_raw):
                return torch.sum(eps_raw**2, dim=0).T                    # [K, U]
        else:
            self._noise_shape = (K, P, U)
            mppi_update = self._make_modular_update()

            def scaled(eps_raw, stdev):
                return eps_raw * stdev

            def sq_sum(eps_raw):
                return torch.sum(eps_raw**2, dim=1)                      # [K, U]

        def update(state: MPPIVarState, s, params, eps_raw):
            u, mppi_state, diag = mppi_update(
                MPPIState(state.generator, state.u_nom, state.u_prev), s, params,
                scaled(eps_raw, state.stdev))
            stdev = self._stdev_step(state.stdev, diag["J_logged"], sq_sum(eps_raw), P)
            return (u, MPPIVarState(state.generator, mppi_state.u_nom, u, stdev),
                    dict(diag, stdev_logged=stdev))

        self.update = update

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_noise(state))

        return step_fn

    def _make_batched_var_step(self, num_slots: int, per_slot_dyn=(), per_slot_cost=()):
        """B-session mppi-var step for the batched-mpc controller (JAX
        ``mppi_var.py:149``): MPPI's K4 step (``_make_batched_semi_fused_step``'s
        ``update_from_eps``: all sessions in one launch, or one of K4's
        emit_terminal form under a learned value terminal, each session's
        V joining its costs before its softmax and its adaptation) on each
        slot's raw normals scaled by its own ``stdev [U]``, then each
        session's sigma step over its ``[K]`` costs.

        Returns ``(step, update)``: ``step(states, s [B,1,S], dyn, cost,
        attrs, mask [B]) -> (u [B,U], states', costs [B,K])`` over the
        stacked state (``stdev [B, U]``), each active slot drawing its raw
        ``[P, U, K]`` normals from its own generator and a frozen one
        drawing nothing, so a session's draws depend neither on B nor on
        the other slots' masks; ``update(states, s, dyn, cost, attrs,
        eps_raw [B,P,U,K])`` is the deterministic part, for tests that feed
        the JAX draws."""
        B = int(num_slots)
        P = self.interp.number_of_interpolation_inducing_points
        _, update_from_eps = self._make_batched_semi_fused_step(B, per_slot_dyn=per_slot_dyn,
                                                                per_slot_cost=per_slot_cost)

        def update(states, s, dyn, cost, attrs, eps_raw):
            u_nom, costs = update_from_eps(states, s, dyn, cost, attrs,
                                           eps_raw * states.stdev[:, None, :, None])
            u = u_nom[:, 0, :]
            stdev = self._stdev_step(states.stdev, costs,
                                     torch.sum(eps_raw**2, dim=1).transpose(1, 2), P)
            return u, MPPIVarState(states.generator, u_nom[:, None], u, stdev), costs

        def step(states, s, dyn, cost, attrs, mask):
            return update(states, s, dyn, cost, attrs,
                          self._slot_normals(states.generator, mask))

        return step, update
