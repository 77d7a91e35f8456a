"""MPPI — Model Predictive Path Integral optimizer (counterpart of
control_toolkit_tpu/optimizers/mppi.py).

Perturbations are sampled at inducing points with stdev
``SQRTRHOINV/sqrt(dt)`` and linearly interpolated to the horizon; the
nominal plan shifts one step each tick; the MPPI correction cost
``cc_weight*(0.5*(1-1/NU)*R*du^2 + R*u*du + 0.5*R*u^2)`` joins each
rollout's cost; the update is the reward-weighted average of the
perturbations.

Each step is a draw (``sample_noise``) followed by a deterministic
``update(state, s, params, eps)``, so tests can feed both packages the
same random numbers.  Three update paths, chosen as the JAX package
chooses them:

* fully fused (``fully_fused: true`` where ``_can_fully_fuse`` admits
  it): the draw is the counter PRNG's ``seed2 = [seed, 0]`` and K3
  (``ops/fused_mppi.py``) draws the noise in its two passes, scores the
  rollouts and sums the weighted noise; torch applies the update.  Over a
  ``:fast`` predictor both passes draw the fast normals (the JAX
  ``fast_sampling=pred.fast_math``: the model's fast plant).
* semi-fused (default): noise ``[P, U, K]`` at the inducing points goes
  to K2 (``ops/mppi_cost.py``), which interpolates, clips, rolls out and
  scores in one pass; the weighted average is taken at the inducing
  points and interpolated once (linearity of interpolation).  With a
  learned value terminal (``costs/value_terminal.py``) K2's emit_terminal
  form also writes x_H, and ``V(x_H)/(H+1)`` joins the costs before the
  weights; the fully-fused gate then refuses (K3 writes no x_H).
* modular (``semi_fused: false``, ``bounded_update``, or logging on):
  noise ``[K, P, U]`` is interpolated and clipped in torch and scored by
  K1 (``ops/cost_rollout.py``; its emit_terminal form under a value
  terminal) through ``Optimizer._make_cost_only``, or by the full
  trajectory rollout when logging needs it.

Where the fully-fused gate is false, ``fully_fused`` takes the semi-fused
path, as the JAX gate does: an options rule, not a fall back from a
failed kernel.  The batched-mpc controller's B-session steps score every
session in one launch: over an ODE model K4 (``ops/mppi_cost_cols.py``,
``_make_batched_semi_fused_step``; its emit_terminal form under a value
terminal), over a learned model the session-row
form of its kernel (``_batched_columns_step_from_kernel``: K11, K13, K12,
K14).  Not ported yet (they raise ``NotImplementedError``,
ROADMAP): ``optim_steps > 0`` (mppi-optimize),
``calculate_optimal_trajectory``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.counter_prng import DEFAULT_TILE_K, draw_seed2
from control_toolkit_tpu_torch.ops.interpolation import Interpolator
from control_toolkit_tpu_torch.optimizers.base import Optimizer, _not_ported
from control_toolkit_tpu_torch.utils import registry

# What a valued MPPI fleet over a GRU or LSTM needs: the JAX package sends
# it to the vmapped per-slot step (batched_mpc.py:500-504), not ported.
RECURRENT_VALUE_FLEET = ("the vmapped per-slot batched step (taken for a learned value terminal "
                         "in an MPPI fleet over a recurrent net)")


class MPPIState(NamedTuple):
    generator: torch.Generator  # noise source
    u_nom: torch.Tensor         # [1, H, U] nominal plan
    u_prev: torch.Tensor        # [U] last applied control


def make_correction_cost(cc_weight: float, R: float, NU: float):
    """MPPI control-cost term summed over horizon and inputs."""
    def correction_cost(u, delta_u):
        return torch.sum(
            cc_weight
            * (0.5 * (1.0 - 1.0 / NU) * R * delta_u**2
               + R * u * delta_u + 0.5 * R * u**2),
            dim=(1, 2),
        )
    return correction_cost


def make_weight_fn(weighting: str, LBD: float):
    """Rollout-averaging weights ``w(costs, axes)`` (unnormalized):
    ``"softmax"`` = exp(-(S - min S)/LBD); ``"rank[:frac]"`` = truncated
    log-rank weights of the best ceil(frac*K); ``"topk[:frac]"`` = the
    softmax truncated to the best ceil(frac*K)."""
    parts = weighting.split(":")
    mode = parts[0]
    if mode not in ("softmax", "rank", "topk"):
        raise ValueError(
            f"unknown MPPI weighting {weighting!r} (softmax | rank[:frac] | topk[:frac])"
        )
    if mode == "softmax" and len(parts) > 1:
        raise ValueError(f"softmax weighting takes no fraction: {weighting!r}")
    frac = float(parts[1]) if len(parts) > 1 else (0.5 if mode == "rank" else 0.1)
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"weighting fraction must be in (0, 1]: {weighting!r}")

    def weights(S, axes):
        axes = tuple(a % S.ndim for a in axes)
        if mode == "softmax":
            rho = torch.amin(S, dim=axes, keepdim=True)
            return torch.exp(-(S - rho) * (1.0 / LBD))
        rest = [a for a in range(S.ndim) if a not in axes]
        perm = rest + list(axes)
        St = S.permute(perm)
        shp = St.shape
        flat = St.reshape(tuple(shp[: len(rest)]) + (-1,))
        n = flat.shape[-1]
        h = max(1, int(np.ceil(frac * n)))
        order = torch.argsort(flat, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)
        if mode == "rank":
            w = torch.clamp_min(
                float(np.log(h + 0.5)) - torch.log(ranks.to(flat.dtype) + 1.0), 0.0
            )
        else:
            rho = torch.amin(flat, dim=-1, keepdim=True)
            w = torch.where(ranks < h, torch.exp(-(flat - rho) * (1.0 / LBD)),
                            torch.zeros_like(flat))
        return w.reshape(shp).permute(tuple(np.argsort(perm)))

    return weights


def make_reward_weighted_average(LBD: float, weighting: str = "softmax"):
    weight_fn = make_weight_fn(weighting, LBD)

    def reward_weighted_average(S, delta_u):
        w = weight_fn(S, (0,))
        a = torch.sum(w, dim=0)
        return torch.sum(w[:, None, None] * delta_u, dim=0) / a
    return reward_weighted_average


@registry.optimizers.register("mppi")
@registry.optimizers.register("mppi-optimize-tf")
class MPPIOptimizer(Optimizer):
    """MPPI (the ``mppi-optimize`` Adam refinement is not ported yet)."""

    # K3's tile: part of the fused path's function (which counter a rollout
    # reads), and the divisor of K that the fused gate asks for.
    fused_tile_k = DEFAULT_TILE_K

    def __init__(
        self,
        *,
        cc_weight: float = 1.0,
        R: float = 1.0,
        LBD: float = 100.0,
        NU: float = 1000.0,
        SQRTRHOINV: float = 0.03,
        period_interpolation_inducing_points: int = 10,
        fully_fused: bool = False,
        semi_fused: bool = True,
        bounded_update: bool = False,
        weighting: str = "softmax",
        optim_steps: int = 0,
        mppi_LR: float = 0.02,
        adam_beta_1: float = 0.9,
        adam_beta_2: float = 0.999,
        adam_epsilon: float = 1e-7,
        gradmax_clip: float = 1000.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if int(optim_steps) > 0:
            raise _not_ported("MPPI optim_steps > 0 (mppi-optimize)")
        if self.calculate_optimal_trajectory:
            raise _not_ported("calculate_optimal_trajectory")
        self.cc_weight = float(cc_weight)
        self.R = float(R)
        self.LBD = float(LBD)
        self.NU = float(NU)
        self.weighting = str(weighting)
        make_weight_fn(self.weighting, self.LBD)  # a typo fails at construction
        self._SQRTRHOINV = float(SQRTRHOINV)
        self.period_interpolation_inducing_points = int(period_interpolation_inducing_points)
        self.semi_fused = bool(semi_fused)
        self.fully_fused = bool(fully_fused)
        # Nominal = weighted average of the EXECUTED (clipped) controls
        # instead of nominal + weighted raw perturbations (opt-in, departs
        # from the reference; takes the modular path).
        self.bounded_update = bool(bounded_update)

    def configure(self, num_states, num_control_inputs, dt=None, **kwargs):
        if dt is None:
            raise ValueError("MPPI requires dt (mpc_timestep)")
        self.SQRTRHODTINV = self._SQRTRHOINV / float(np.sqrt(dt))
        self.interp = Interpolator.build(
            self.mpc_horizon, self.period_interpolation_inducing_points, self.device
        )
        if self.device.type == "cuda":
            # The update's einsums are float32 matmuls: keep them in full
            # float32, as the JAX reference computes them (no TF32).
            torch.backends.cuda.matmul.allow_tf32 = False
        super().configure(num_states, num_control_inputs, dt=dt, **kwargs)

    def _init_state(self, generator):
        u_mid = 0.5 * (self.action_low + self.action_high)
        u_nom = u_mid.expand(1, self.mpc_horizon, self.num_control_inputs).clone()
        return MPPIState(
            generator=generator,
            u_nom=u_nom,
            u_prev=torch.zeros(self.num_control_inputs, dtype=torch.float32, device=self.device),
        )

    def _can_fully_fuse(self) -> bool:
        """K3 runs the step (``mppi.py:_can_fully_fuse``): the option is on,
        softmax weighting without ``bounded_update`` (the kernels average
        the raw perturbations), logging off, the model and cost K1's
        (``ode`` family), no post-terminal hook (K3 writes no terminal
        states: a learned value terminal takes the semi-fused path, whose
        K2 form emits them), and K divides into K3's tiles.
        ``optim_steps`` and ``calculate_optimal_trajectory`` are refused at
        construction."""
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        return (self.fully_fused and self.weighting == "softmax" and not self.bounded_update
                and not self.optimizer_logging and ode.can_use_cost(self)
                and self._post_terminal_fn() is None
                and self.num_rollouts % self.fused_tile_k == 0)

    def _uses_semi_fused(self) -> bool:
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        return (self.semi_fused and not self.bounded_update and not self._can_fully_fuse()
                and not self.optimizer_logging and ode.can_use_cost(self))

    def sample_noise(self, state: MPPIState) -> torch.Tensor:
        """This step's draw: the perturbations, pre-scaled, ``[P, U, K]``
        for the semi-fused update and ``[K, P, U]`` for the modular one; on
        the fully-fused path K3's ``seed2 = [seed, 0]`` (int32, on the
        device: it never goes through the host)."""
        if self._noise_shape is None:
            return draw_seed2(state.generator, self.device)
        eps = torch.randn(self._noise_shape, generator=state.generator,
                          dtype=torch.float32, device=self.device)
        return eps * self.SQRTRHODTINV

    def _make_step_fn(self):
        K, U = self.num_rollouts, self.num_control_inputs
        P = self.interp.number_of_interpolation_inducing_points
        if self._can_fully_fuse():
            self._noise_shape = None
            self.update = self._make_fully_fused_update()
        elif self._uses_semi_fused():
            self._noise_shape = (P, U, K)
            self.update = self._make_semi_fused_update()
        else:
            self._noise_shape = (K, P, U)
            self.update = self._make_modular_update()

        def step_fn(state, s, params):
            return self.update(state, s, params, self.sample_noise(state))

        return step_fn

    def _make_fully_fused_update(self):
        from control_toolkit_tpu_torch.ops.fused_mppi import fused_mppi_step
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        model, pack = ode.rollout_model(self)
        kernels.require("K3", model.plant)
        W = self.interp.matrix                                    # [P, H]
        low, high = self.action_low, self.action_high
        consts = (self.cc_weight, self.R, self.NU, self.LBD, self.SQRTRHODTINV,
                  self.num_rollouts, self.fused_tile_k)

        def update(state: MPPIState, s, params, seed2):
            u_nom = torch.cat([state.u_nom[:, 1:, :], state.u_nom[:, -1:, :]], dim=1)[0]
            pvec = pack(params, state.u_prev)
            u_nom_new, costs = fused_mppi_step(model, s[0], u_nom, pvec, seed2, W, low, high,
                                               *consts)
            u = u_nom_new[0, :]
            diag = {"u_nom": u_nom_new[None], "J_logged": costs}
            return u, MPPIState(state.generator, u_nom_new[None], u), diag

        return update

    def _make_semi_fused_update(self):
        """The semi-fused update over K2; with a post-terminal hook (a
        learned value terminal) over K2's emit_terminal form, the hook's
        ``post(x_H)/(H+1)`` joining the costs before the weights (JAX
        ``mppi.py:131-156``)."""
        from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost, mppi_cost_emit
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        model, pack = ode.rollout_model(self)
        post, H = self._post_terminal_fn(), self.mpc_horizon
        kernels.require("K2" if post is None else "K2's emit_terminal form", model.plant)
        W = self.interp.matrix                                    # [P, H]
        low, high = self.action_low, self.action_high
        cc_weight, R, NU = self.cc_weight, self.R, self.NU
        weight_fn = make_weight_fn(self.weighting, self.LBD)

        def update(state: MPPIState, s, params, eps):
            u_nom = torch.cat([state.u_nom[:, 1:, :], state.u_nom[:, -1:, :]], dim=1)
            pvec = pack(params, state.u_prev)
            if post is None:
                costs = mppi_cost(model, s[0], u_nom[0], pvec, eps, W, low, high,
                                  cc_weight, R, NU)               # [K]
            else:
                costs, x_term = mppi_cost_emit(model, s[0], u_nom[0], pvec, eps, W, low, high,
                                               cc_weight, R, NU)
                costs = costs + post(x_term, self._cost_params(params)) / (H + 1)
            w = weight_fn(costs, (0,))
            # Weighted average at the inducing points, then one
            # interpolation: sum_k w_k (W eps_k) == W (sum_k w_k eps_k).
            ws = torch.einsum("k,puk->up", w, eps) / torch.sum(w)
            b = torch.einsum("ph,up->hu", W, ws)
            u_nom = torch.clamp(u_nom + b[None], low, high)
            u = u_nom[0, 0, :]
            diag = {"u_nom": u_nom, "J_logged": costs}
            return u, MPPIState(state.generator, u_nom, u), diag

        return update

    def sample_slot_noise(self, generators, mask) -> torch.Tensor:
        """The batched step's draw, pre-scaled: one ``randn`` from each
        active slot's generator, zeros for a frozen slot (it draws nothing),
        in the layout of the batched step built last: ``[B, P, U, K]`` for
        K4's (``_make_batched_semi_fused_step``), ``[B, K, P, U]`` for the
        learned models' (``_batched_columns_step_from_kernel``)."""
        return self._slot_normals(generators, mask) * self.SQRTRHODTINV

    def _slot_normals(self, generators, mask) -> torch.Tensor:
        """``sample_slot_noise``'s standard normals, before the scale."""
        shape = self._slot_noise_shape
        zeros = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return torch.stack([
            torch.randn(shape, generator=g, dtype=torch.float32, device=self.device)
            if on else zeros
            for g, on in zip(generators, mask)
        ])

    def _make_batched_semi_fused_step(self, num_slots: int, per_slot_dyn=()):
        """B-session semi-fused MPPI step for the batched-mpc controller
        (JAX ``mppi.py:369-511``): all B sessions' rollouts in one K4
        launch (``ops/mppi_cost_cols.py``), each session reading its own
        initial state, shifted nominal plan, attributes, previous control
        and ``per_slot_dyn`` constants (``pvec_b``); the softmax and the
        weighted average at the inducing points run per session as torch
        ops over ``[B, K]``.  With a post-terminal hook (a learned value
        terminal) the launch is K4's emit_terminal form and each session's
        ``post(x_H)/(H+1)`` joins its costs before its softmax (JAX
        ``mppi.py:420-470``).

        Returns ``(step, update_from_eps)``: ``step(states, s [B,1,S], dyn,
        cost, attrs, mask [B]) -> (u [B,U], states', costs [B,K])`` over the
        stacked state (``generator`` a tuple of the slots' generators,
        ``u_nom [B,1,H,U]``, ``u_prev [B,U]``); ``update_from_eps(states, s,
        dyn, cost, attrs, eps [B,P,U,K]) -> (u_nom_new [B,H,U], costs)`` is
        the deterministic part, for tests that feed the JAX draws.  Each
        active slot draws its noise from its own generator and a frozen one
        (``mask`` false) draws nothing, so a session's draws depend neither
        on B nor on the other slots' masks."""
        from control_toolkit_tpu_torch.ops.counter_prng import ROWS
        from control_toolkit_tpu_torch.ops.mppi_cost_cols import (
            mppi_cost_cols, mppi_cost_cols_emit,
        )
        from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
        from control_toolkit_tpu_torch.optimizers.kernel_families import ode

        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        if not ode.compatible_model(self):
            raise ValueError("semi-fused batched MPPI covers the ODE models of the device plants")
        B, K = int(num_slots), self.num_rollouts
        if K % ROWS:
            raise ValueError(f"batched MPPI needs K % {ROWS} == 0; got K={K}")
        model, _ = ode.rollout_model(self)
        post, inv_h1 = self._post_terminal_fn(), 1.0 / (self.mpc_horizon + 1)
        kernels.require("K4" if post is None else "K4's emit_terminal form", model.plant)
        _, slot_keys = split_slot_keys(model.param_keys, per_slot_dyn)
        pack = make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, B, self.device)
        W, low, high = self.interp.matrix, self.action_low, self.action_high
        self._slot_noise_shape = (W.shape[0], self.num_control_inputs, K)
        cc_weight, R, NU = self.cc_weight, self.R, self.NU
        weight_fn = make_weight_fn(self.weighting, self.LBD)

        def update_from_eps(states, s, dyn, cost, attrs, eps):
            u_nom = torch.cat([states.u_nom[:, 0, 1:, :], states.u_nom[:, 0, -1:, :]], dim=1)
            pvec_b = pack(states.u_prev, dyn, cost, attrs)
            operands = (model, s[:, 0, :].contiguous(), u_nom, pvec_b, eps, W, low, high,
                        cc_weight, R, NU)
            if post is None:
                costs = mppi_cost_cols(*operands)                         # [B, K]
            else:
                costs, x_term = mppi_cost_cols_emit(*operands)            # x_H [B, K, S]
                v = post(x_term.reshape(B * K, -1), {"cost": cost, "attrs": attrs}) * inv_h1
                costs = costs + v.reshape(B, K)
            w = weight_fn(costs, (1,))
            # Per session: the weighted average at the inducing points, then
            # one interpolation (linearity, as the single-session update).
            ws = torch.einsum("bk,bpuk->bup", w, eps) / torch.sum(w, dim=1)[:, None, None]
            b_upd = torch.einsum("ph,bup->bhu", W, ws)
            return torch.clamp(u_nom + b_upd, low, high), costs

        def step(states, s, dyn, cost, attrs, mask):
            u_nom, costs = update_from_eps(states, s, dyn, cost, attrs,
                                           self.sample_slot_noise(states.generator, mask))
            u = u_nom[:, 0, :]
            return u, MPPIState(states.generator, u_nom[:, None], u), costs

        return step, update_from_eps

    def _make_batched_neural_step(self, num_slots: int):
        """B-session MPPI step over a learned MLP (JAX ``mppi.py:513``): all
        B sessions' rollouts in one launch of K11's session-row form
        (``ops/neural_rollout.py:neural_cost_rollout_cols``; with a learned
        value terminal its emit_terminal form, ``neural_cost_rollout_cols_emit``),
        the net's weights shared.  Returns ``(step, update_from_eps)`` as
        ``_batched_columns_step_from_kernel`` builds them."""
        from control_toolkit_tpu_torch.ops.neural_rollout import (
            neural_cost_rollout_cols, neural_cost_rollout_cols_emit,
        )
        from control_toolkit_tpu_torch.optimizers.kernel_families import neural

        model, _ = neural.net_model(self)
        if model.kind != "mlp":
            raise ValueError("the batched neural step covers MLP models; a GRU or LSTM takes "
                             "_make_batched_recurrent_step")
        post = self._post_terminal_fn()
        kernels.require("K11's session-row form" if post is None
                        else "K11's session-row emit_terminal form", model.plant)
        cols = neural_cost_rollout_cols if post is None else neural_cost_rollout_cols_emit
        return self._batched_columns_step_from_kernel(
            num_slots, model.param_keys,
            lambda s0, Q, pvec_b, dyn: cols(model, s0, Q, pvec_b, dyn["net"]), post=post)

    def _make_batched_residual_step(self, num_slots: int, per_slot_dyn=()):
        """B-session MPPI step over ``"ODE+res"`` (JAX ``mppi.py:574``): one
        launch of K12's session-row form
        (``ops/residual_rollout.py:residual_cost_rollout_cols``; with a
        learned value terminal its emit_terminal form), the residual's
        weights shared; ``per_slot_dyn`` moves the named base constants into
        the sessions' rows, so each session plans against its own plant.
        The base constants are read from ``dyn["base"]``."""
        from control_toolkit_tpu_torch.ops.residual_rollout import (
            residual_cost_rollout_cols, residual_cost_rollout_cols_emit,
        )
        from control_toolkit_tpu_torch.optimizers.kernel_families import residual

        model, _ = residual.residual_model(self)
        post = self._post_terminal_fn()
        kernels.require("K12's session-row form" if post is None
                        else "K12's session-row emit_terminal form", model.plant)
        cols = residual_cost_rollout_cols if post is None else residual_cost_rollout_cols_emit
        return self._batched_columns_step_from_kernel(
            num_slots, model.param_keys,
            lambda s0, Q, pvec_b, dyn: cols(model, s0, Q, pvec_b, dyn["res"]),
            per_slot_dyn=per_slot_dyn, dyn_leaves_fn=lambda dyn: dyn["base"], post=post)

    def _make_batched_gp_step(self, num_slots: int):
        """B-session MPPI step over a sparse GP (JAX ``mppi.py:625``): one
        launch of K14's session-row form
        (``ops/gp_rollout.py:gp_cost_rollout_cols``; with a learned value
        terminal its emit_terminal form), the GP's operands shared and
        flattened once a posterior (a re-fit swaps in without a rebuild)."""
        from control_toolkit_tpu_torch.ops.gp_rollout import (
            gp_cost_rollout_cols, gp_cost_rollout_cols_emit,
        )
        from control_toolkit_tpu_torch.optimizers.kernel_families import gp

        model, _ = gp.gp_model(self)
        operands = gp.cached_operands()
        post = self._post_terminal_fn()
        kernels.require("K14's session-row form" if post is None
                        else "K14's session-row emit_terminal form", model.plant)
        cols = gp_cost_rollout_cols if post is None else gp_cost_rollout_cols_emit
        return self._batched_columns_step_from_kernel(
            num_slots, model.param_keys,
            lambda s0, Q, pvec_b, dyn: cols(model, s0, Q, pvec_b, operands(dyn["gp"])),
            post=post)

    def _make_batched_recurrent_step(self, num_slots: int):
        """B-session MPPI step over a stacked GRU/LSTM (JAX ``mppi.py:749``):
        one launch of K13's session-row form
        (``ops/neural_rollout.py:recurrent_cost_rollout_cols``), each
        session's rollouts starting from its own hidden; the cells' weights
        shared.  Returns ``(step, update_from_eps)`` with ``step(states, s,
        dyn, cost, attrs, mask, hidden)`` and ``update_from_eps(states, s,
        dyn, cost, attrs, hidden, delta_b)``, ``hidden`` the per-slot tuple
        of ``[B, 1, Hi]`` leaves (JAX's layout).  The hidden's advance with
        the applied control is the caller's (the batched-mpc controller).
        A learned value terminal is refused: the JAX package sends a valued
        recurrent fleet to the vmapped per-slot step (its recurrent
        session-row kernel emits no terminal states), which the port does
        not have."""
        from control_toolkit_tpu_torch.ops.neural_rollout import recurrent_cost_rollout_cols
        from control_toolkit_tpu_torch.optimizers.kernel_families import neural

        model, _ = neural.net_model(self)
        if model.kind == "mlp":
            raise ValueError("the batched recurrent step covers GRU and LSTM models; an MLP "
                             "takes _make_batched_neural_step")
        if self._post_terminal_fn() is not None:
            raise _not_ported(RECURRENT_VALUE_FLEET)
        kernels.require("K13's session-row form", model.plant)
        step, update = self._batched_columns_step_from_kernel(
            num_slots, model.param_keys,
            lambda s0, Q, pvec_b, dyn, hidden: recurrent_cost_rollout_cols(
                model, s0, Q, pvec_b, dyn["net"], tuple(h[:, 0, :] for h in hidden)))
        return step, (lambda states, s, dyn, cost, attrs, hidden, delta_b:
                      update(states, s, dyn, cost, attrs, delta_b, hidden))

    def _batched_columns_step_from_kernel(self, num_slots: int, param_keys, costs_fn,
                                          per_slot_dyn=(), dyn_leaves_fn=None, post=None):
        """The shared tail of the learned models' batched MPPI steps (JAX
        ``mppi.py:670``): each session's noise at the inducing points is
        interpolated and clipped into its controls, all B sessions'
        rollouts are scored by ``costs_fn(s0 [B*K,S], Q [B*K,H,U], pvec_b
        [B,N], dyn[, hidden]) -> [B, K]`` (one launch of a session-row
        kernel), and the correction cost, the softmax and the weighted
        average run per session as torch ops.  ``pvec_b`` packs each
        session's attributes, previous control and ``per_slot_dyn``
        constants (``make_slot_packer`` over ``param_keys``, the dynamics
        constants read from ``dyn_leaves_fn(dyn)``).  The controls ``Q`` go
        to one buffer allocated here, once a build.  ``post``: a learned
        value terminal; ``costs_fn`` is then a session-row emit_terminal
        form returning ``(costs [B, K], x_H [B, K, S])``, and each session's
        V(x_H)/(H+1) joins its costs before the correction cost and the
        softmax (JAX ``mppi.py:670-720``), the order of K4's emit path.

        Returns ``(step, update_from_eps)``: ``step(states, s [B,1,S], dyn,
        cost, attrs, mask [B][, hidden]) -> (u [B,U], states', costs
        [B,K])``, each active slot drawing its noise ``[K, P, U]`` from its
        own generator and a frozen one drawing nothing
        (``sample_slot_noise``), so a session's draws depend neither on B
        nor on the other slots' masks; ``update_from_eps(states, s, dyn,
        cost, attrs, delta_b [B,K,P,U][, hidden]) -> (u_nom_new [B,H,U],
        costs [B,K])`` is the deterministic part, fed the JAX draws in the
        tests (the JAX steps' modular layout, ``mppi.py:732-737``)."""
        from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys

        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        if (post is None) != (cf.post_terminal_cost is None):
            raise ValueError("a learned value terminal needs its kernel's emit_terminal form "
                             "(post), and only with one")
        B, K = int(num_slots), self.num_rollouts
        H, U = self.mpc_horizon, self.num_control_inputs
        P = self.interp.number_of_interpolation_inducing_points
        self._slot_noise_shape = (K, P, U)
        _, slot_keys = split_slot_keys(param_keys, per_slot_dyn)
        pack = make_slot_packer(param_keys, slot_keys, cf.attr_defaults, B, self.device)
        dyn_leaves_fn = dyn_leaves_fn or (lambda dyn: dyn)
        interp, low, high = self.interp, self.action_low, self.action_high
        weight_fn = make_weight_fn(self.weighting, self.LBD)
        correction_cost = make_correction_cost(self.cc_weight, self.R, self.NU)
        inv_h1 = 1.0 / (H + 1)
        Q = torch.empty(B, K, H, U, dtype=torch.float32, device=self.device)

        def update_from_eps(states, s, dyn, cost, attrs, delta_b, *hidden):
            unom_b = torch.cat([states.u_nom[:, 0, 1:, :], states.u_nom[:, 0, -1:, :]], dim=1)
            delta = interp.interpolate(delta_b.reshape(B * K, P, U)).reshape(B, K, H, U)
            u_run = torch.clamp(unom_b[:, None] + delta, low, high, out=Q)
            pvec_b = pack(states.u_prev, dyn_leaves_fn(dyn), cost, attrs)
            s0 = s[:, 0, :].repeat_interleave(K, dim=0)                     # [B*K, S]
            costs = costs_fn(s0, u_run.reshape(B * K, H, U), pvec_b, dyn, *hidden)
            if post is not None:
                costs, x_term = costs
                v = post(x_term.reshape(B * K, -1), {"cost": cost, "attrs": attrs}) * inv_h1
                costs = costs + v.reshape(B, K)
            costs = costs + correction_cost(u_run.reshape(B * K, H, U),
                                            delta.reshape(B * K, H, U)).reshape(B, K)
            w = weight_fn(costs, (1,))
            upd = torch.einsum("bk,bkhu->bhu", w, delta) / torch.sum(w, dim=1)[:, None, None]
            return torch.clamp(unom_b + upd, low, high), costs

        def step(states, s, dyn, cost, attrs, mask, *hidden):
            u_nom, costs = update_from_eps(states, s, dyn, cost, attrs,
                                           self.sample_slot_noise(states.generator, mask),
                                           *hidden)
            u = u_nom[:, 0, :]
            return u, MPPIState(states.generator, u_nom[:, None], u), costs

        return step, update_from_eps

    def _make_modular_update(self):
        K = self.num_rollouts
        low, high = self.action_low, self.action_high
        interp = self.interp
        correction_cost = make_correction_cost(self.cc_weight, self.R, self.NU)
        reward_weighted_average = make_reward_weighted_average(self.LBD, self.weighting)
        cost_only = None if self.optimizer_logging else self._make_cost_only()
        bounded = self.bounded_update

        def update(state: MPPIState, s, params, delta_u):
            s_tiled = s[:1].expand(K, -1).contiguous()
            u_nom = torch.cat([state.u_nom[:, 1:, :], state.u_nom[:, -1:, :]], dim=1)
            delta_u = interp.interpolate(delta_u)
            u_run = torch.clamp(u_nom + delta_u, low, high)
            if cost_only is not None:
                base_cost = cost_only(s_tiled, u_run, state.u_prev, params)
                traj = None
            else:
                base_cost, traj = self._rollout_and_cost(s_tiled, u_run, state.u_prev, params)
            traj_cost = base_cost + correction_cost(u_run, delta_u)
            if bounded:
                u_nom = reward_weighted_average(traj_cost, u_run)[None]
            else:
                u_nom = torch.clamp(
                    u_nom + reward_weighted_average(traj_cost, delta_u)[None], low, high
                )
            u = u_nom[0, 0, :]
            diag = {"u_nom": u_nom, "J_logged": traj_cost}
            if cost_only is None:
                diag.update({"Q_logged": u_run, "rollout_trajectories_logged": traj})
            return u, MPPIState(state.generator, u_nom, u), diag

        return update
