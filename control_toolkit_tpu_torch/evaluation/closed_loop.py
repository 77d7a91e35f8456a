"""Closed-loop evaluation: controller and plant advanced together on the
controller's device (counterpart of
control_toolkit_tpu/evaluation/closed_loop.py).

``run(s0, ticks)`` is one episode: each tick the optimizer's step, the
actuator noise (the loop's own generator, on the controller's device), the
clip to the action bounds, the realized stage cost
``stage_cost_step(s, u_applied, u_prev)`` and the plant's
``step_dynamics``, with nothing copied to the host inside the episode but
what the optimizer's own step reads (iLQR's); the trajectory is copied
once at the end.  ``run_device`` is the raw episode, for timing.

A stateful (GRU/LSTM) predictor's hidden is threaded through the ticks and
advanced with the commanded control, before the noise (the reference's
``predictor.update``); the final hidden is written back to the predictor.

``run_batch(s0s [N, S], ticks)`` is a Monte-Carlo sweep of N episodes, each
on a fresh optimizer state with its own stream (``slot_seed(seed, n)``, the
batched controller's keying) and its own actuator noise; the controller's
live state is untouched.  Where the batched controller would serve the
optimizer with a batched kernel step (``controllers/batched_mpc.py``
``FleetGates``: K4 for ``ode`` and ``mppi-var``, K6 for ``cem-fused``, the
session-row forms of K7-K10 with K1/K11/K12/K14 for ``rpgd`` and
``gradient``, of K11, K12, K14 for ``neural``, ``residual``, ``gp``), each
tick of all N episodes is one launch of it (one an iteration); modular CEM,
a stateful predictor and everything else run the episodes one after the
other.  ``sweep_params`` turns the sweep into a parameter sweep: episode n
runs with row n of every swept leaf; scalar attributes, dynamics constants
(a residual model's ``dyn.base.<k>`` too) and cost weights ride the kernel
step as ``per_slot_dyn`` / ``per_slot_cost`` rows.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from control_toolkit_tpu_torch.utils.rng import make_generator, slot_seed

# The kernel sweeps that also carry per-episode dynamics constants and cost
# weights (JAX closed_loop.py:170-173); the others carry attributes alone.
_ROW_KINDS = ("ode", "rpgd", "gradient", "residual", "mppi-var", "cem-fused")


def _plant_on(env, device: torch.device):
    """``env``, or a shallow copy whose tensor-valued params live on
    ``device`` (the port's environments default to the CPU); numbers stay
    numbers, so the plant's arithmetic is the environment's own."""
    params = getattr(env, "params", None)
    if not isinstance(params, dict) or all(isinstance(v, (int, float)) for v in params.values()):
        return env
    plant = copy.copy(env)
    plant.params = {k: v if isinstance(v, (int, float))
                    else torch.as_tensor(v, dtype=torch.float32, device=device)
                    for k, v in params.items()}
    plant.device = device
    return plant


class ClosedLoop:
    """Controller and plant loop for one optimizer and one environment."""

    def __init__(self, controller, env, actuator_noise: Optional[float] = None,
                 noise_seed: int = 0):
        # The environment's own actuator noise unless overridden, so the
        # loop replicates env.step.
        if actuator_noise is None:
            actuator_noise = getattr(env, "actuator_noise", 0.0)
        self.controller = controller
        self.env = env
        self.actuator_noise = float(actuator_noise)
        self.device = controller.device
        self._noise_gen = make_generator(noise_seed, self.device)
        self._plant = _plant_on(env, self.device)
        self._a_low = torch.as_tensor(np.asarray(env.action_low, np.float32), device=self.device)
        self._a_high = torch.as_tensor(np.asarray(env.action_high, np.float32),
                                       device=self.device)
        self._bind()

    def _bind(self):
        """Bind the controller's current optimizer; again (``_ensure_fresh``)
        whenever it is rebuilt (``configure()``, ``attach_value_terminal()``),
        so a loop never evaluates a stale objective; the noise stream
        survives."""
        opt = self.controller.optimizer
        self.optimizer = opt
        self._opt_epoch = getattr(opt, "_build_epoch", 0)
        self._stateful = bool(opt.predictor is not None and opt.predictor.is_stateful)
        self._kernel_steps: Dict[tuple, object] = {}

    def _ensure_fresh(self):
        opt = self.controller.optimizer
        if opt is not self.optimizer or getattr(opt, "_build_epoch", 0) != self._opt_epoch:
            self._bind()

    def _noise(self, shape) -> Optional[torch.Tensor]:
        """Standard normals ``shape + (U,)`` from the loop's generator, or
        None without actuator noise (nothing drawn)."""
        if self.actuator_noise <= 0.0:
            return None
        return torch.randn(tuple(shape) + (self.optimizer.num_control_inputs,),
                           generator=self._noise_gen, dtype=torch.float32, device=self.device)

    def _plant_tick(self, s, u, u_prev, noise, cp):
        """Noise, clip, realized stage cost and the plant's step over rows
        ``s [R, S]``, ``u [R, U]``: ``(u_applied, stage [R], s_next)``."""
        if noise is not None:
            u = u + self.actuator_noise * noise
        u = torch.clamp(u, self._a_low, self._a_high)
        cf = self.controller.cost_function.cost_function
        stage = cf.stage_cost_step(s, u, u_prev, cp)
        return u, stage, self._plant.step_dynamics(s, u, self.env.dt)

    def _episode(self, state, s0: torch.Tensor, params: Dict, noise, ticks: int):
        """``ticks`` ticks from ``s0 [S]`` on ``state``; ``noise [T, U]`` or
        None.  Returns ``(state, s_T [S], states [T,S], controls [T,U],
        stage_costs [T], hidden)``; the hidden (a stateful predictor's,
        else ``()``) enters through ``params["dyn"]["hidden"]``, as the step
        reads it, and is advanced with the commanded control."""
        step_fn, U = self.optimizer._step_fn, self.optimizer.num_control_inputs
        cp = {"cost": params["cost"], "attrs": params["attrs"]}
        hidden = params["dyn"]["hidden"] if self._stateful else ()
        if self._stateful:
            rnn_apply, net = self.optimizer.predictor.predictor._rnn_apply, params["dyn"]["net"]
        s, u_prev = s0, torch.zeros(U, dtype=torch.float32, device=self.device)
        ss, us, stages = [], [], []
        for t in range(ticks):
            p = {**params, "dyn": dict(params["dyn"], hidden=hidden)} if self._stateful else params
            u, state, _ = step_fn(state, s[None, :], p)
            u = u.reshape(U)
            if self._stateful:
                _, hidden = rnn_apply(net, torch.cat([s[None, :], u[None, :]], dim=-1), hidden)
            u_app, stage, s_next = self._plant_tick(
                s[None, :], u[None, :], u_prev[None, :],
                None if noise is None else noise[t][None, :], cp)
            ss.append(s)
            us.append(u_app[0])
            stages.append(stage[0])
            s, u_prev = s_next[0], u_app[0]
        return (state, s, torch.stack(ss), torch.stack(us), torch.stack(stages), hidden)

    def run_device(self, opt_state, s0: torch.Tensor, params: Dict, ticks: int):
        """The raw episode (for timing): ``_episode`` on the device from
        ``opt_state`` with this call's actuator noise, nothing copied to the
        host.  Returns ``(state, s_T, states, controls, stage_costs,
        hidden)`` as tensors."""
        self._ensure_fresh()
        return self._episode(opt_state, s0, params, self._noise((ticks,)), ticks)

    def run(self, s0: np.ndarray, ticks: int, reset: bool = True) -> Dict[str, np.ndarray]:
        """One episode; returns {'states' [T,S], 'controls' [T,U],
        'stage_costs' [T], 'final_state' [S], 'mean_cost'}.  ``reset``
        starts the optimizer (and a stateful predictor's hidden) over;
        without it the episode continues from the controller's state."""
        self._ensure_fresh()
        opt = self.optimizer
        if reset:
            opt.optimizer_reset()
            if self._stateful:
                opt.predictor.predictor.reset_state()
        params = self.controller._assemble_params()
        s0 = torch.as_tensor(np.reshape(np.asarray(s0, np.float32), (-1,)), device=self.device)
        state, sT, ss, us, stage, hT = self.run_device(opt.opt_state, s0, params, ticks)
        opt.opt_state = state
        if self._stateful:
            # Hand the final hidden back: a follow-up per-tick loop or an
            # episode with reset=False continues where this one ended.
            opt.predictor.predictor.hidden = hT
        stage = stage.cpu().numpy()
        return {"states": ss.cpu().numpy(), "controls": us.cpu().numpy(), "stage_costs": stage,
                "final_state": sT.cpu().numpy(), "mean_cost": float(np.mean(stage))}

    # ---- Monte-Carlo and parameter sweeps ----------------------------------
    def _episode_states(self, N: int) -> list:
        """N fresh optimizer states, episode n's on ``slot_seed(seed, n)``."""
        opt = self.optimizer
        return [opt._init_state(make_generator(slot_seed(opt._seed, n), self.device))
                for n in range(N)]

    def _sweep_kind(self) -> Optional[str]:
        """The batched kernel step that N episodes take (the batched
        controller's gates), or None: the episodes one after the other.  A
        stateful predictor takes the per-episode path, as in JAX."""
        from control_toolkit_tpu_torch.controllers.batched_mpc import SweepGates

        if self._stateful:
            return None
        return SweepGates(self.optimizer)._kernel_kind()

    def _kernel_step(self, kind: str, N: int, per_slot_dyn=(), per_slot_cost=()):
        from control_toolkit_tpu_torch.controllers.batched_mpc import build_kernel_step

        key = (kind, N, tuple(sorted(per_slot_dyn)), tuple(sorted(per_slot_cost)))
        if key not in self._kernel_steps:
            self._kernel_steps[key] = build_kernel_step(self.optimizer, kind, N,
                                                        per_slot_dyn=key[2], per_slot_cost=key[3])
        return self._kernel_steps[key]

    def _swept_rows(self, swept_paths, params) -> Optional[Tuple[tuple, tuple]]:
        """``(per_slot_dyn, per_slot_cost)`` when every swept leaf is a
        per-episode scalar that the kernel step carries in its rows (JAX
        ``_swept_kernel_run_for``): an attribute of the cost, a dynamics
        constant (a residual model's under ``dyn.base``) or a cost weight;
        None when one needs the per-episode path."""
        from control_toolkit_tpu_torch.models.residual_predictor import ResidualPredictor

        cf = self.controller.cost_function.cost_function
        pred = getattr(self.optimizer.predictor, "predictor", self.optimizer.predictor)
        attr_keys = set(getattr(cf, "attr_keys", ()))
        dyn_keys, cost_keys = [], []
        for path in swept_paths:
            top, _, leaf = path.partition(".")
            tree = params[top]
            dyn_defaults = pred.default_params() if top == "dyn" else {}
            if top == "dyn" and leaf.startswith("base.") and isinstance(pred, ResidualPredictor):
                # "ODE+res": the base's constants, one level down; the
                # batched steps nest their rows under "base" themselves.
                leaf, tree, dyn_defaults = leaf[len("base."):], tree["base"], dyn_defaults["base"]
            if "." in leaf or getattr(tree[leaf], "ndim", -1) != 1:
                return None
            if top == "attrs":
                if leaf not in attr_keys:
                    return None
            elif top == "dyn":
                if leaf not in dyn_defaults:
                    return None
                dyn_keys.append(leaf)
            elif top == "cost":
                if leaf not in getattr(cf, "dynamic_config_keys", ()):
                    return None
                cost_keys.append(leaf)
            else:
                return None
        return tuple(dyn_keys), tuple(cost_keys)

    def _kernel_episodes(self, kstep, states, s0s, params, noise, ticks: int):
        """N episodes on a batched kernel step: each tick one call of
        ``kstep`` over the stacked states, then the plant over ``[N, S]``.
        Returns ``(s_T [N,S], states [N,T,S], controls [N,T,U], stage_costs
        [N,T])``."""
        N, U = s0s.shape[0], self.optimizer.num_control_inputs
        mask = np.ones(N, bool)
        cp = {"cost": params["cost"], "attrs": params["attrs"]}
        s, u_prev = s0s, torch.zeros(N, U, dtype=torch.float32, device=self.device)
        ss, us, stages = [], [], []
        for t in range(ticks):
            u, states, _ = kstep(states, s[:, None, :], params["dyn"], params["cost"],
                                 params["attrs"], mask)
            u_app, stage, s_next = self._plant_tick(s, u, u_prev,
                                                    None if noise is None else noise[:, t], cp)
            ss.append(s)
            us.append(u_app)
            stages.append(stage)
            s, u_prev = s_next, u_app
        return s, torch.stack(ss, dim=1), torch.stack(us, dim=1), torch.stack(stages, dim=1)

    def run_batch(self, s0_batch: np.ndarray, ticks: int, return_trajectories: bool = False,
                  mesh=None, sweep_params: Optional[Dict] = None) -> Dict[str, np.ndarray]:
        """Monte-Carlo sweep of N episodes; see the module docstring.

        ``sweep_params`` is a nested overlay of the assembled params tree
        ('cost', 'attrs', 'dyn' leaves) whose leaves carry a leading ``[N]``
        episode axis (``_overlay_sweep``): episode n runs with row n of every
        swept leaf.

        Returns {'mean_costs' [N], 'stage_costs' [N,T], 'final_states'
        [N,S], 'final_hidden' (stateful only, each cell ``[N, 1, Hi]``)},
        plus 'states' [N,T,S] / 'controls' [N,T,U] with
        ``return_trajectories``."""
        if mesh is not None:
            raise NotImplementedError(
                "run_batch over a mesh is not ported to control_toolkit_tpu_torch yet "
                "(ROADMAP A10)")
        self._ensure_fresh()
        s0s_np = np.asarray(s0_batch, np.float32)
        if s0s_np.ndim != 2:
            raise ValueError(f"s0_batch must be [N, S], got {s0s_np.shape}")
        N = s0s_np.shape[0]
        s0s = torch.as_tensor(s0s_np, device=self.device)
        states = self._episode_states(N)
        noise = self._noise((N, ticks))
        params = self.controller._assemble_params()
        axes = None
        if sweep_params is not None:
            params, axes, swept_paths = _overlay_sweep(params, sweep_params, N)
            if not swept_paths:
                raise ValueError("sweep_params contains no leaves to sweep")
        kind, rows = self._sweep_kind(), ((), ())
        if axes is not None:
            # A parameter sweep rides the kernel step of _ROW_KINDS alone
            # (JAX closed_loop.py:170-173), and only with every leaf a row.
            rows = self._swept_rows(swept_paths, params) if kind in _ROW_KINDS else None
            if rows is None:
                kind, rows = None, ((), ())
        hT = ()
        if kind is not None:
            from control_toolkit_tpu_torch.controllers.batched_mpc import _stack_states

            kstep = self._kernel_step(kind, N, *rows)
            sT, ss, us, stage = self._kernel_episodes(kstep, _stack_states(states), s0s,
                                                      params, noise, ticks)
        else:
            outs = [self._episode(states[n], s0s[n], _row(params, axes, n),
                                  None if noise is None else noise[n], ticks)
                    for n in range(N)]
            sT, ss, us, stage = (torch.stack([o[i] for o in outs]) for i in (1, 2, 3, 4))
            if self._stateful:
                hT = tuple(torch.stack([o[5][c] for o in outs]) for c in range(len(outs[0][5])))
        stage = stage.cpu().numpy()
        out = {"mean_costs": np.mean(stage, axis=1), "stage_costs": stage,
               "final_states": sT.cpu().numpy()}
        if self._stateful:
            out["final_hidden"] = tuple(h.cpu().numpy() for h in hT)
        if return_trajectories:
            out["states"] = ss.cpu().numpy()
            out["controls"] = us.cpu().numpy()
        return out


# ---- parameter-sweep overlay helpers ------------------------------------
def _overlay_sweep(params: Dict, sweep: Dict, N: int):
    """Merge a sweep overlay into the assembled params tree (JAX
    ``closed_loop.py:639``).  ``sweep`` mirrors a subset of ``params``'s
    dict structure; each of its leaves has shape ``[N, *base_leaf.shape]``
    (scalars sweep as ``[N]``) and becomes a tensor of the base leaf's dtype
    on its device.  Returns ``(merged, axes, sorted swept paths)``, ``axes``
    the tree of 0 (swept) and None (unswept: passed through whole, net
    weights and hidden tuples too)."""
    swept: list = []

    def rec(base, over, path):
        if not isinstance(base, dict):
            raise KeyError(f"sweep path '{'.'.join(path)}' descends into a non-dict params node "
                           f"({type(base).__name__})")
        merged, axes = {}, {}
        for k, bv in base.items():
            if k not in over:
                merged[k], axes[k] = bv, None
                continue
            ov = over[k]
            if isinstance(ov, dict):
                merged[k], axes[k] = rec(bv, ov, path + (k,))
                continue
            dotted = ".".join(path + (k,))
            base_t = torch.as_tensor(bv)
            arr = torch.as_tensor(np.asarray(ov)).to(dtype=base_t.dtype, device=base_t.device)
            want = (N,) + tuple(base_t.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"sweep leaf '{dotted}' has shape {tuple(arr.shape)}; expected "
                                 f"{want} ([N, *base_shape] for N={N} episodes)")
            merged[k], axes[k] = arr, 0
            swept.append(dotted)
        unknown = set(over) - set(base)
        if unknown:
            raise KeyError(f"sweep keys {sorted(unknown)} not present in params"
                           f"{' at ' + '.'.join(path) if path else ''} (have: {sorted(base)})")
        return merged, axes

    merged, axes = rec(params, sweep, ())
    return merged, axes, sorted(swept)


def _row(params, axes, n: int):
    """Episode ``n``'s params tree: row n of every swept leaf."""
    if axes is None:
        return params
    if isinstance(axes, dict):
        return {k: _row(params[k], axes[k], n) for k in params}
    return params[n]
