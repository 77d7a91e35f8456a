"""iLQR trajectory optimizer, the NLP-solver slot (counterpart of
control_toolkit_tpu/optimizers/ilqr.py), registered as ``ilqr``,
``nlp-ilqr`` and ``nlp-forces``.

One open-loop plan a tick (K is forced to 1), solved by iterative LQR over
the predictor's one-step transition and the cost's stage and terminal
costs:

* the quadratic model along the trajectory (``linearize``): the dynamics'
  Jacobian over ``(z, u)`` and the stage cost's gradient and Hessian over
  ``(z, u)``, all H stages at once with ``torch.func`` under ``vmap``
  (``jacrev`` of the transition, ``grad`` and ``jacrev(jacrev)`` of the
  cost: reverse mode, a tenth of forward mode's host time over these
  graphs), sliced into A, B, lx, lu, lxx, luu, lux; the terminal cost's
  gradient and Hessian give Vx, Vxx;
* the Riccati pass with Levenberg-Marquardt regularization, either the
  sequential recursion (``backward_sequential``) or the log-depth one
  (``backward_parallel``: Särkkä & García-Fernández's conditional value
  function elements, combined by a suffix scan of ceil(log2(H+1)) levels,
  the regularizer folded into the stage control cost);
* the line search over ``line_search_steps`` step sizes, all at once
  (``forward_pass``), the controls clamped into the action box; the best
  candidate is accepted when it improves the augmented cost by ``tol``,
  and the regularizer halves (floored at 1e-6) or grows tenfold (capped at
  ``regularization_max``);
* a symmetric state box (``state_max``) and a terminal box of
  ``terminal_set_width`` around ``terminal_set_center`` (floats or names of
  attributes) by a PHR augmented-Lagrangian outer loop of ``al_iterations``
  multiplier updates, ``ceil(max_iterations / al_iterations)`` inner
  iterations each;
* the control-change cost through a state augmented with the previous
  control, ``z = [x, u_prev]``;
* ``n_starts`` solves from the warm start, the policy start and uniform
  draws in the box (``sample_draws``), one batch: every tensor of the solve
  has a leading start dimension, one start included.  Selection is
  feasible-first under constraints, non-finite solves masked out;
* the FORCES exit-flag replay: a non-finite solve replays the last good
  plan index by index, the warm start then the remaining plan, extended by
  ``initial_guess_policy`` rollouts where a policy is given, else reset to
  the box's middle when the plan runs out.

Every transition is evaluated as the JAX package evaluates it, one row at
a time (``one_row_step``): an ensemble plans under its members' mean
transition however many rows a batch holds.  The solve's trip counts are
fixed and it reads nothing back to the host: the step counter is a host
int and the policy's tail is the only branch on a solve's outcome, one
read of ``solver_ok`` a tick where a policy is given.  Singular matrices
give non-finite gains (``inv_ex``/``solve_ex`` without error checks), which
the replay catches.  The passes are exposed for tests as the optimizer's
attributes after ``configure``: ``linearize``, ``backward_sequential``,
``backward_parallel``, ``forward_pass``, ``inner_iteration``,
``multiplier_update``, ``rollout``, ``solve``, ``policy_guess`` and
``update(state, s, params, draws[, trace])``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from control_toolkit_tpu_torch.optimizers.base import Optimizer
from control_toolkit_tpu_torch.utils import registry


class ILQRState(NamedTuple):
    generator: torch.Generator
    u_traj: torch.Tensor   # [H, U] warm start of the next solve
    u_prev: torch.Tensor   # [U] last applied control
    plan: torch.Tensor     # [H, U] last good open-loop solution (failure replay)
    j: torch.Tensor        # 0-d int64: replay index into plan (0 = a fresh solve adopted)
    count: int             # host counter: control steps


class Quadratic(NamedTuple):
    """The quadratic model of a trajectory, leading dims ``[N, H]`` (the
    terminal blocks ``[N]``)."""
    A: torch.Tensor    # [N, H, Z, Z]
    B: torch.Tensor    # [N, H, Z, U]
    lx: torch.Tensor   # [N, H, Z]
    lu: torch.Tensor   # [N, H, U]
    lxx: torch.Tensor  # [N, H, Z, Z]
    luu: torch.Tensor  # [N, H, U, U]
    lux: torch.Tensor  # [N, H, U, Z]
    Vx: torch.Tensor   # [N, Z]
    Vxx: torch.Tensor  # [N, Z, Z]


def one_row_step(predictor):
    """``(x [R, S], u [R, U], params) -> [R, S]``, each row's transition as
    the predictor's ``single_step`` gives it for that row alone: the step
    itself for a predictor whose rows are independent, the members' mean
    for an ensemble (whose step splits a batch that E divides into member
    blocks)."""
    pred = getattr(predictor, "predictor", predictor)
    if getattr(pred, "n_members", 1) > 1:
        return pred.member_mean_step
    return predictor.single_step


@registry.optimizers.register("ilqr")
@registry.optimizers.register("nlp-ilqr")
@registry.optimizers.register("nlp-forces")  # the reference's name for the slot
class ILQROptimizer(Optimizer):
    def __init__(
        self,
        *,
        max_iterations: int = 50,
        tol: float = 1e-6,
        regularization_init: float = 1.0,
        regularization_max: float = 1e8,
        line_search_steps: int = 8,
        state_max: Optional[Sequence] = None,
        terminal_set_width: float = 0.0,
        idx_terminal_set: Sequence[int] = (),
        terminal_set_center: Sequence = (),
        al_iterations: int = 4,
        mu_init: float = 10.0,
        mu_growth: float = 10.0,
        include_control_change_cost: bool = True,
        n_starts: int = 1,
        riccati: str = "sequential",
        initial_guess_policy=None,
        **kwargs,
    ):
        kwargs["num_rollouts"] = 1  # one trajectory (the reference's NLP slot)
        super().__init__(**kwargs)
        self.max_iterations = int(max_iterations)
        self.tol = float(tol)
        self.reg_init = float(regularization_init)
        self.reg_max = float(regularization_max)
        self.alphas = [0.5 ** i for i in range(int(line_search_steps))]
        # Symmetric box |x_i| <= state_max[i]; 'inf' or None leaves x_i free.
        if state_max is not None:
            self.state_max = np.asarray(
                [np.inf if v in (None, "inf") else float(v) for v in state_max], np.float32)
        else:
            self.state_max = None
        self.terminal_set_width = float(terminal_set_width)
        self.idx_terminal_set = tuple(int(i) for i in idx_terminal_set)
        # Each entry a float or the name of an attribute, read from
        # params["attrs"] at each step.
        self.terminal_set_center = tuple(terminal_set_center)
        self.al_iterations = int(al_iterations)
        self.mu_init = float(mu_init)
        self.mu_growth = float(mu_growth)
        self.include_control_change_cost = bool(include_control_change_cost)
        self.n_starts = max(1, int(n_starts))
        if riccati not in ("sequential", "parallel"):
            raise ValueError(f"riccati must be sequential|parallel, got {riccati!r}")
        self.riccati = riccati
        # A callable (x [S], params) -> u [U]: the first step's plan, one
        # start of a multi-start solve and the replay's tail.  This class
        # has no _apply_policy_guess: the base's warm start stays disarmed.
        self.initial_guess_policy = initial_guess_policy

    def configure(self, num_states, num_control_inputs, dt=None, **kwargs):
        if self.predictor is None or self.predictor.single_step is None:
            pred = getattr(self.predictor, "predictor", self.predictor)
            spec = getattr(self.predictor, "_spec", None)
            raise ValueError(
                f"{self.registered_name} linearizes a one-step transition, and the predictor "
                f"{type(pred).__name__}" + (f" ({spec!r})" if spec else "")
                + " has no single_step (a recurrent or probabilistic model, or TS-1 sampling)")
        super().configure(num_states, num_control_inputs, dt=dt, **kwargs)
        if self.device.type == "cuda":
            # The passes' small products in full float32, as the JAX
            # package computes them (no TF32).
            torch.backends.cuda.matmul.allow_tf32 = False

    @property
    def n_draws(self) -> int:
        """Rows of a step's multi-start draw: one a random start, plus the
        spare that stands in for the policy start on the first step."""
        n_extra = 2 if self.initial_guess_policy is not None else 1
        return max(self.n_starts - n_extra, 0) + 1

    def _init_state(self, generator):
        H, U = self.mpc_horizon, self.num_control_inputs
        u_mid = (0.5 * (self.action_low + self.action_high)).to(torch.float32)
        plan0 = u_mid.expand(H, U).clone()
        return ILQRState(
            generator=generator, u_traj=plan0, plan=plan0.clone(),
            u_prev=torch.zeros(U, dtype=torch.float32, device=self.device),
            j=torch.zeros((), dtype=torch.int64, device=self.device), count=0,
        )

    def sample_draws(self, state: ILQRState) -> Optional[torch.Tensor]:
        """This step's multi-start draws, ``[n_draws, H, U]`` uniform in the
        action box; None with one start."""
        if self.n_starts == 1:
            return None
        low = self.action_low.to(torch.float32)
        r = torch.rand((self.n_draws, self.mpc_horizon, self.num_control_inputs),
                       generator=state.generator, dtype=torch.float32, device=self.device)
        return low + (self.action_high.to(torch.float32) - low) * r

    def _make_step_fn(self):
        H, U, S = self.mpc_horizon, self.num_control_inputs, self.num_states
        f32 = dict(dtype=torch.float32, device=self.device)
        low, high = self.action_low.to(torch.float32), self.action_high.to(torch.float32)
        cf = getattr(self.cost_function, "cost_function", self.cost_function)
        step = one_row_step(self.predictor)
        alphas = torch.tensor(self.alphas, **f32)
        n_alpha = len(self.alphas)
        zero = torch.zeros((), **f32)
        inf = torch.full((), float("inf"), **f32)

        # ---- the constraints (static) ---------------------------------------
        box = ([i for i in range(min(S, len(self.state_max))) if np.isfinite(self.state_max[i])]
               if self.state_max is not None else [])
        has_box = bool(box)
        box_cols = torch.tensor(box, dtype=torch.int64, device=self.device)
        box_max = torch.tensor([float(self.state_max[i]) for i in box], **f32)
        term = self.idx_terminal_set
        has_term = self.terminal_set_width > 0.0 and len(term) > 0
        term_cols = torch.tensor(term, dtype=torch.int64, device=self.device)
        width = torch.tensor(self.terminal_set_width, **f32)
        constrained = has_box or has_term
        n_al = self.al_iterations if constrained else 1
        inner_iters = max(1, -(-self.max_iterations // n_al))
        n_box, n_term = 2 * len(box), 2 * len(term)

        use_ccrc = self.include_control_change_cost
        Z = S + U if use_ccrc else S
        eye_u, eye_z = torch.eye(U, **f32), torch.eye(Z, **f32)
        u_mid = (0.5 * (low + high)).expand(H, U)
        steps_h = torch.arange(H, device=self.device)
        policy, n_starts = self.initial_guess_policy, self.n_starts
        backward_kind = self.riccati
        reg_init, reg_max, tol = self.reg_init, self.reg_max, self.tol
        mu_init, mu_growth = np.float32(self.mu_init), np.float32(self.mu_growth)

        # ---- per-row costs and dynamics: z [R, Z], u [R, U] -----------------
        def dyn(z, u, params):
            xn = step(z[:, :S], u, params["dyn"])
            return torch.cat([xn, u], dim=-1) if use_ccrc else xn

        def box_violation(z):
            xb = z[:, box_cols]
            return torch.cat([xb - box_max, -box_max - xb], dim=-1)

        def term_violation(z, center):
            d = z[:, term_cols] - center
            return torch.cat([d - width, -d - width], dim=-1)

        def al_penalty(c, lam, mu):
            """PHR term of ``c(z) <= 0`` a row: ``torch.maximum``, whose
            derivative at a tie is 0.5 each way, as ``jnp.maximum``'s."""
            t = torch.maximum(lam + mu * c, zero)
            return torch.sum(t * t - lam * lam, dim=-1) / (2.0 * mu)

        def stage_l(z, u, params):
            cp = {"cost": params["cost"], "attrs": params["attrs"]}
            return cf.stage_cost_step(z[:, :S], u, z[:, S:] if use_ccrc else None, cp)

        def term_l(z, params):
            return cf.get_terminal_cost(z[:, :S], {"cost": params["cost"],
                                                   "attrs": params["attrs"]})

        def stage_l_al(z, u, lam, mu, params):
            c = stage_l(z, u, params)
            return c + al_penalty(box_violation(z), lam, mu) if has_box else c

        def term_l_al(z, lam, lam_t, mu, center, params):
            c = term_l(z, params)
            if has_box:
                c = c + al_penalty(box_violation(z), lam, mu)
            if has_term:
                c = c + al_penalty(term_violation(z, center), lam_t, mu)
            return c

        # ---- trajectories: a leading start dimension N ----------------------
        def rollout(z0, us, params):
            """``z0 [N, Z]``, ``us [N, H, U]`` -> ``[N, H+1, Z]``."""
            zs = [z0]
            for h in range(H):
                zs.append(dyn(zs[-1], us[:, h], params))
            return torch.stack(zs, dim=1)

        def total_cost_al(zs, us, lam, lam_t, mu, center, params):
            """The augmented cost ``[N]`` of rolled trajectories."""
            N = us.shape[0]
            stages = stage_l_al(zs[:, :-1].reshape(N * H, Z), us.reshape(N * H, U),
                                lam[:, :-1].reshape(N * H, n_box), mu, params)
            return stages.reshape(N, H).sum(dim=1) + term_l_al(
                zs[:, -1], lam[:, -1], lam_t, mu, center, params)

        def total_cost_true(zs, us, params):
            N = us.shape[0]
            stages = stage_l(zs[:, :-1].reshape(N * H, Z), us.reshape(N * H, U), params)
            return stages.reshape(N, H).sum(dim=1) + term_l(zs[:, -1], params)

        def total_violation(zs, center):
            """Summed positive violation ``[N]`` of rolled plans (the stage
            box along the trajectory, the terminal set at its end): the
            feasibility half of the multi-start selection."""
            N = zs.shape[0]
            v = torch.zeros(N, **f32)
            if has_box:
                c = torch.maximum(box_violation(zs.reshape(N * (H + 1), Z)), zero)
                v = v + c.sum(dim=-1).reshape(N, H + 1).sum(dim=1)
            if has_term:
                v = v + torch.maximum(term_violation(zs[:, -1], center), zero).sum(dim=-1)
            return v

        def policy_u(z, params):
            u = torch.as_tensor(policy(z[:S], params), dtype=torch.float32, device=z.device)
            return torch.clamp(u.reshape(U), low, high)

        def policy_guess(z0, params):
            """``[H, U]``: the policy rolled through the dynamics from ``z0 [Z]``."""
            z, us = z0[None], []
            for _ in range(H):
                us.append(policy_u(z[0], params))
                z = dyn(z, us[-1][None], params)
            return torch.stack(us)

        def extend_tail(us, n_valid, z0, params):
            """The first ``n_valid`` (a device int) controls of ``us [H, U]``,
            then the policy's, all rolled from ``z0``."""
            z, out = z0[None], []
            for i in range(H):
                out.append(torch.where(i < n_valid, us[i], policy_u(z[0], params)))
                z = dyn(z, out[-1][None], params)
            return torch.stack(out)

        # ---- the quadratic model --------------------------------------------
        def linearize(zs, us, lam, lam_t, mu, center, params) -> Quadratic:
            # The rest of a step runs under inference mode; its tensors are
            # cloned into ones that torch.func may differentiate through.
            with torch.inference_mode(False):
                return _linearize(*(t.clone() for t in (zs, us, lam, lam_t, center)), mu,
                                  params)

        def _linearize(zs, us, lam, lam_t, center, mu, params) -> Quadratic:
            N = us.shape[0]
            zu = torch.cat([zs[:, :-1], us], dim=-1).reshape(N * H, Z + U)
            lam_h = lam[:, :-1].reshape(N * H, n_box)

            def f(zu1):
                return dyn(zu1[None, :Z], zu1[None, Z:], params)[0]

            def sl(zu1, lam1):
                return stage_l_al(zu1[None, :Z], zu1[None, Z:], lam1[None], mu, params)[0]

            def tl(z1, lam1, lam_t1):
                return term_l_al(z1[None], lam1[None], lam_t1[None], mu, center, params)[0]

            def step_and_grad(zu1, lam1):
                g1 = grad(sl)(zu1, lam1)
                return (f(zu1), g1), g1

            def tl_grad(z1, lam1, lam_t1):
                g1 = grad(tl)(z1, lam1, lam_t1)
                return g1, g1

            # One reverse pass for the transition's Jacobian and the stage
            # cost's Hessian (the Jacobian of its gradient, the gradient its aux).
            (J, Hs), g = vmap(jacrev(step_and_grad, has_aux=True))(zu, lam_h)
            J, Hs = J.reshape(N, H, Z, Z + U), Hs.reshape(N, H, Z + U, Z + U)
            g = g.reshape(N, H, Z + U)
            Vxx, Vx = vmap(jacrev(tl_grad, has_aux=True))(zs[:, -1], lam[:, -1], lam_t)
            return Quadratic(A=J[..., :Z], B=J[..., Z:], lx=g[..., :Z], lu=g[..., Z:],
                             lxx=Hs[..., :Z, :Z], luu=Hs[..., Z:, Z:], lux=Hs[..., Z:, :Z],
                             Vx=Vx, Vxx=Vxx)

        # ---- the Riccati passes: gains ks [N, H, U], Ks [N, H, U, Z] ---------
        def mv(M, v):
            return (M @ v[..., None])[..., 0]

        def backward_sequential(q: Quadratic, reg):
            """The Riccati recursion, each stage's expansion over (z, u) at
            once: Q = l'' + J' Vxx J, q = l' + J' Vx with J = [A | B]."""
            reg_eye = reg[:, None, None] * eye_u
            J = torch.cat([q.A, q.B], dim=-1)
            g = torch.cat([q.lx, q.lu], dim=-1)
            Hs = torch.cat([torch.cat([q.lxx, q.lux.mT], dim=-1),
                            torch.cat([q.lux, q.luu], dim=-1)], dim=-2)
            Vx, Vxx = q.Vx, q.Vxx
            ks, Ks = [None] * H, [None] * H
            for h in reversed(range(H)):
                Jh = J[:, h]
                JV = Jh.mT @ Vxx
                Q = Hs[:, h] + JV @ Jh
                qv = g[:, h] + (Jh.mT @ Vx[..., None])[..., 0]
                Qux, Quu = Q[:, Z:, :Z], Q[:, Z:, Z:] + reg_eye
                Quu_inv = torch.linalg.inv_ex(Quu, check_errors=False).inverse
                rhs = torch.cat([qv[:, Z:, None], Qux], dim=-1)             # [Qu | Qux]
                kK = -(Quu_inv @ rhs)                                         # [k | K]
                Kg = kK[..., 1:]
                # [Vx | Vxx] = [Qx | Qxx] + K'Quu[k | K] + K'[Qu | Qux] + Qux'[k | K]
                W = Kg.mT @ (Quu @ kK + rhs) + Qux.mT @ kK
                V = torch.cat([qv[:, :Z, None], Q[:, :Z, :Z]], dim=-1) + W
                Vx, Vxx = V[..., 0], V[..., 1:]
                Vxx = 0.5 * (Vxx + Vxx.mT)
                ks[h], Ks[h] = kK[..., 0], Kg
            return torch.stack(ks, dim=1), torch.stack(Ks, dim=1)

        def combine(earlier, later):
            """The composition of two segments' conditional value functions
            ``E(x, z) = 1/2 x'Jx - e'x + 1/2 (z - Ax - b)' C^+ (z - Ax - b)``
            (minimum over the junction state): JAX ``ilqr.py:366-388``,
            its three solves against L and two against L' each one solve
            of a concatenated right-hand side."""
            A1, b1, C1, e1, J1 = earlier
            A2, b2, C2, e2, J2 = later
            L = eye_z + C1 @ J2
            rhs = torch.cat([A1, (b1 + mv(C1, e2))[..., None], C1], dim=-1)
            sol = torch.linalg.solve_ex(L, rhs, check_errors=False).result
            sA, sb, sC = sol[..., :Z], sol[..., Z], sol[..., Z + 1:]
            rhs_t = torch.cat([(e2 - mv(J2, b1))[..., None], J2], dim=-1)
            sol_t = torch.linalg.solve_ex(L.mT, rhs_t, check_errors=False).result
            A_n = A2 @ sA
            b_n = mv(A2, sb) + b2
            C_n = A2 @ sC @ A2.mT + C2
            e_n = mv(A1.mT, sol_t[..., 0]) + e1
            J_n = A1.mT @ sol_t[..., 1:] @ A1 + J1
            return A_n, b_n, 0.5 * (C_n + C_n.mT), e_n, 0.5 * (J_n + J_n.mT)

        def suffix_scan(elems):
            """Inclusive suffix composition along dim 1, ``out[i] = x[i] o
            x[i+1] o ... o x[T-1]``: at level d every element not yet
            reaching the end absorbs the one d later (Hillis-Steele, in
            ceil(log2 T) levels)."""
            T, d = elems[0].shape[1], 1
            while d < T:
                head = combine(tuple(e[:, :T - d] for e in elems),
                               tuple(e[:, d:] for e in elems))
                elems = tuple(torch.cat([hd, e[:, T - d:]], dim=1) for hd, e in zip(head, elems))
                d *= 2
            return elems

        def backward_parallel(q: Quadratic, reg):
            N = q.A.shape[0]
            Rr = q.luu + reg[:, None, None, None] * eye_u
            Rinv = torch.linalg.inv_ex(Rr, check_errors=False).inverse
            BRi = q.B @ Rinv
            luxT = q.lux.mT
            zeros_zz = torch.zeros(N, 1, Z, Z, **f32)
            elems = (
                torch.cat([q.A - BRi @ q.lux, zeros_zz], dim=1),
                torch.cat([-mv(BRi, q.lu), torch.zeros(N, 1, Z, **f32)], dim=1),
                torch.cat([BRi @ q.B.mT, zeros_zz], dim=1),
                torch.cat([-(q.lx - mv(luxT, mv(Rinv, q.lu))), -q.Vx[:, None]], dim=1),
                torch.cat([q.lxx - luxT @ Rinv @ q.lux, q.Vxx[:, None]], dim=1),
            )
            suffix = suffix_scan(elems)
            Vxx_next, Vx_next = suffix[4][:, 1:], -suffix[3][:, 1:]
            BT = q.B.mT
            Qu = q.lu + mv(BT, Vx_next)
            Quu = Rr + BT @ Vxx_next @ q.B
            Qux = q.lux + BT @ Vxx_next @ q.A
            sol = torch.linalg.solve_ex(Quu, torch.cat([Qu[..., None], Qux], dim=-1),
                                        check_errors=False).result
            return -sol[..., 0], -sol[..., 1:]

        backward = backward_parallel if backward_kind == "parallel" else backward_sequential

        # ---- the line search, the inner iteration, the AL loop --------------
        def forward_pass(z0, zs_nom, us_nom, ks, Ks, lam, lam_t, mu, center, params):
            """Every step size from every start at once, rows ``[N, A]``:
            ``(costs [N, A], us [N, A, H, U], zs [N, A, H+1, Z])``."""
            N = us_nom.shape[0]
            R = N * n_alpha
            z = z0.expand(N * n_alpha, Z)
            lam_r = lam[:, None].expand(N, n_alpha, H + 1, n_box).reshape(R, H + 1, n_box)
            lam_t_r = lam_t[:, None].expand(N, n_alpha, n_term).reshape(R, n_term)
            us, zs = [], [z]
            for h in range(H):
                dz = z.reshape(N, n_alpha, Z) - zs_nom[:, None, h]
                u = us_nom[:, None, h] + alphas[None, :, None] * ks[:, None, h] \
                    + mv(Ks[:, None, h], dz)
                u = torch.clamp(u, low, high).reshape(R, U)
                z = dyn(z, u, params)
                us.append(u)
                zs.append(z)
            us_r, zs_r = torch.stack(us, 1), torch.stack(zs, 1)
            # The stage costs of all steps at once, summed in the steps' order.
            stages = stage_l_al(zs_r[:, :H].reshape(R * H, Z), us_r.reshape(R * H, U),
                                lam_r[:, :H].reshape(R * H, n_box), mu, params).reshape(R, H)
            acc = torch.zeros(R, **f32)
            for h in range(H):
                acc = acc + stages[:, h]
            total = acc + term_l_al(z, lam_r[:, H], lam_t_r, mu, center, params)
            return (total.reshape(N, n_alpha), us_r.reshape(N, n_alpha, H, U),
                    zs_r.reshape(N, n_alpha, H + 1, Z))

        def take(t, idx):
            """``t[n, idx[n]]`` for each start n, by a gather (no host read)."""
            shape = (idx.shape[0], 1) + (1,) * (t.dim() - 2)
            out = torch.take_along_dim(t, idx.reshape(shape), dim=1)
            return out[:, 0]

        def inner_iteration(z0, us, zs, cost, reg, lam, lam_t, mu, center, params):
            """One backward pass and line search of each start: ``(us, zs,
            cost, reg)`` after the accept/reject and the LM update."""
            ks, Ks = backward(linearize(zs, us, lam, lam_t, mu, center, params), reg)
            costs, us_c, zs_c = forward_pass(z0, zs, us, ks, Ks, lam, lam_t, mu, center, params)
            best = torch.argmin(costs, dim=1)
            best_cost = take(costs, best)
            improved = best_cost < cost - tol
            us_new = torch.where(improved[:, None, None], take(us_c, best), us)
            zs_new = torch.where(improved[:, None, None], take(zs_c, best), zs)
            cost_new = torch.where(improved, best_cost, cost)
            reg_new = torch.where(improved, torch.clamp_min(reg * 0.5, 1e-6),
                                  torch.clamp_max(reg * 10.0, reg_max))
            return us_new, zs_new, cost_new, reg_new

        def multiplier_update(zs, lam, lam_t, mu, center):
            """First-order PHR update along the accepted trajectories."""
            N = zs.shape[0]
            if has_box:
                c = box_violation(zs.reshape(N * (H + 1), Z)).reshape(N, H + 1, n_box)
                lam = torch.maximum(lam + mu * c, zero)
            if has_term:
                lam_t = torch.maximum(lam_t + mu * term_violation(zs[:, -1], center), zero)
            return lam, lam_t

        def solve(z0, us0, center, params, trace=None):
            """``us0 [N, H, U]`` -> the solved plans ``[N, H, U]``, each start
            its own LM regularizer, all with one multiplier schedule.  A list
            ``trace`` receives each inner iteration's arguments and result."""
            N = us0.shape[0]
            z0n = z0.expand(N, Z)
            lam = torch.zeros(N, H + 1, n_box, **f32)
            lam_t = torch.zeros(N, n_term, **f32)
            mu, us = (mu_init if constrained else np.float32(0.0)), us0
            for _ in range(n_al):
                zs = rollout(z0n, us, params)
                cost = total_cost_al(zs, us, lam, lam_t, float(mu), center, params)
                reg = torch.full((N,), reg_init, **f32)
                for _ in range(inner_iters):
                    args = (z0, us, zs, cost, reg, lam, lam_t, float(mu), center)
                    us, zs, cost, reg = inner_iteration(*args, params)
                    if trace is not None:
                        trace.append((args, (us, zs, cost, reg)))
                if constrained:
                    lam, lam_t = multiplier_update(zs, lam, lam_t, float(mu), center)
                    mu = mu * mu_growth
            return us

        center_spec = self.terminal_set_center

        def resolve_center(params):
            if not has_term:
                return torch.zeros(0, **f32)
            vals = [torch.as_tensor(params["attrs"].get(e, 0.0) if isinstance(e, str) else e,
                                    **f32).reshape(()) for e in center_spec]
            vals += [zero] * (len(term) - len(vals))
            return torch.stack(vals[:len(term)])

        def pick(t, i):
            """``t[i]`` for a device index ``i`` (no host read)."""
            return torch.index_select(t, 0, i.reshape(1))[0]

        def update(state: ILQRState, s, params, draws=None, trace=None):
            # No autograd bookkeeping on the step's ~1e4 small operations an
            # iteration (the linearization leaves inference mode for its own).
            with torch.inference_mode():
                return _update(state, s, params, draws, trace)

        def _update(state, s, params, draws, trace):
            if n_starts > 1 and (draws is None or tuple(draws.shape) != (self.n_draws, H, U)):
                raise ValueError(f"{n_starts} starts need draws of shape "
                                 f"{(self.n_draws, H, U)}")
            x0 = s[0].to(torch.float32)
            z0 = torch.cat([x0, state.u_prev]) if use_ccrc else x0
            center = resolve_center(params)
            first = state.count == 0
            # The policy's plan replaces the uninformative first warm start.
            u_warm = policy_guess(z0, params) if policy is not None and first else state.u_traj
            if n_starts == 1:
                us0 = u_warm[None]
            else:
                # The warm start, the policy's start (the spare draw on the
                # first step, where the warm start is the policy's), draws.
                heads = [u_warm[None]]
                if policy is not None:
                    heads.append((draws[-1] if first else policy_guess(z0, params))[None])
                us0 = torch.cat(heads + [draws[:-1]], dim=0)[:n_starts]
            us_all = solve(z0, us0, center, params, trace)
            zs_all = rollout(z0.expand(us_all.shape[0], Z), us_all, params)
            costs_all = total_cost_true(zs_all, us_all, params)
            if n_starts == 1:
                us, cost = us_all[0], costs_all[0]
            else:
                finite = torch.isfinite(costs_all)
                costs_all = torch.where(finite, costs_all, inf)
                if constrained:
                    # Feasible-first: the cheapest feasible solve, else the
                    # least violating one.
                    viol = torch.where(finite, total_violation(zs_all, center), inf)
                    feasible = viol <= 1e-5
                    best = torch.where(feasible.any(),
                                       torch.argmin(torch.where(feasible, costs_all, inf)),
                                       torch.argmin(viol))
                else:
                    best = torch.argmin(costs_all)
                us, cost = pick(us_all, best), pick(costs_all, best)

            # The FORCES exit flag: a failed solve replays the last good
            # plan index by index; a good one is adopted, the index reset.
            ok = torch.isfinite(cost) & torch.isfinite(us).all()
            j_new = torch.where(ok, torch.zeros_like(state.j), torch.clamp_max(state.j + 1, H - 1))
            plan_new = torch.where(ok, us, state.plan)
            u = torch.where(ok, us[0], pick(state.plan, j_new))
            shift = torch.where(ok, torch.ones_like(j_new), j_new + 1)
            us_shifted = plan_new.index_select(0, torch.clamp(steps_h + shift, 0, H - 1))
            if policy is not None:
                # The remaining plan extended by the policy's rollouts: the
                # step's one read of the solve's outcome.
                if not bool(ok):
                    us_shifted = extend_tail(us_shifted, H - shift, z0, params)
            else:
                us_shifted = torch.where(j_new >= H - 1, u_mid, us_shifted)

            # The diagnostics describe the plan applied from this state: on a
            # replay the remaining plan, tail-clamped.
            plan_diag = plan_new.index_select(0, torch.clamp(steps_h + j_new, 0, H - 1))
            zs_plan = rollout(z0[None], plan_diag[None], params)
            cost_applied = torch.where(ok, cost, total_cost_true(zs_plan, plan_diag[None],
                                                                 params)[0])
            diag = {
                "Q_logged": plan_diag[None],
                "J_logged": (cost_applied / (H + 1))[None],
                "rollout_trajectories_logged": zs_plan[:, :, :S],
                "u_nom": plan_new[None],
                "solver_ok": ok,
            }
            new_state = ILQRState(generator=state.generator, u_traj=us_shifted, u_prev=u,
                                  plan=plan_new, j=j_new, count=state.count + 1)
            return u, new_state, diag

        self.linearize, self.forward_pass = linearize, forward_pass
        self.backward_sequential, self.backward_parallel = backward_sequential, backward_parallel
        self.inner_iteration, self.multiplier_update = inner_iteration, multiplier_update
        self.rollout, self.solve, self.update = rollout, solve, update
        self.policy_guess = policy_guess

        def step_fn(state, s, params):
            return update(state, s, params, self.sample_draws(state))

        return step_fn
