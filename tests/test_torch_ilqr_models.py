"""The port's iLQR over every predictor and plant, against the JAX
package's ``ILQROptimizer``, and the JAX package's iLQR loops over the
other plants.

* One step over each plant's exact ODE and cartpole's ``:fast`` one, the
  committed MLP, a seeded sparse GP (``gp_file``), ``"ODE+res"`` with a nonzero
  residual, the committed 4 x mlp-32-32 ensemble and a learned value
  terminal, each at H=10 and 3 iterations from the same state: u, the
  plan and J_logged to STEP_TOL (test_torch_ilqr.py).
* The ensemble's one-row semantics: the JAX solver evaluates every
  transition at batch 1, so an ensemble plans under its members' mean.
  Its 8-alpha line search has 8 rows, a multiple of E=4, where the
  predictor's own ``single_step`` splits the rows into member blocks
  (TS-inf): the port's line search matches the per-row mean and not the
  blocks.
* The JAX loops: ``tests/test_pointmass.py:174`` runs whole (100 ticks,
  ~55 s of one CPU thread), at its configuration and threshold.
  The multi-start escape (``tests/test_ilqr.py:260``, 2 x 80 ticks at
  H=40, 25 iterations) and the two quadrotor hovers
  (``tests/test_quadrotor2d.py:60``, ``tests/test_quadrotor3d.py:87``, 200
  ticks at H=40, 20 iterations) take several minutes eagerly on a CPU,
  so the port is held per step at their configurations instead: at
  LOOP_TICKS of the JAX loop, from the state, optimizer state and draws
  that JAX recorded there (``tests/golden/ilqr_loops.npz``), the port's u,
  plan and J_logged against JAX's to LOOP_TOL.  ``PYTHONPATH=. python
  tests/test_torch_ilqr_models.py --record`` from the repository's root
  reruns the JAX loops, checks their thresholds and rewrites the file
  (~1 min).

LOOP_TOL: a full solve of 20-25 iterations from the same state, each
accepted line search carrying the passes' float32 rounding (the JAX
package's own comment, ``tests/test_ilqr.py:323-325``); the largest read
here is 6.3e-4 on a plan (the multi-start's tick 60).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.pointmass import PointMassEnv
from control_toolkit_tpu_torch.optimizers.ilqr import ILQRState
from test_torch_ilqr import STEP_TOL, close, port_state
from test_torch_plants import PLANTS, limits, states
from test_torch_residual import bench_residual
from test_torch_value import ASSETS, attach_both, jax_value_net

GOLDEN = Path(__file__).parent / "golden" / "ilqr_loops.npz"
LOOP_TOL = dict(rtol=2e-3, atol=2e-3)
LOOP_TICKS = (0, 20, 60)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def small_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 10, "num_rollouts": 1,
           "max_iterations": 3, "tol": 1e-7, "regularization_init": 1.0,
           "regularization_max": 1e8, "line_search_steps": 8}
    cfg.update(extra)
    return cfg


def pair(env, limits_, attrs, cfg, spec="ODE", cost=None, logging=True):
    """The JAX and the port controller, both logging, one config."""
    ctrls = []
    for Ctrl, extra in ((JaxMPC, {}), (MPCController, {"device": "cpu"})):
        ctrl = Ctrl(env, limits_, dict(attrs),
                    config={"optimizer": "ilqr", "controller_logging": logging,
                            "cost_function_specification": cost, **extra})
        ctrl.configure(optimizer_name="ilqr", predictor_specification=spec,
                       optimizer_config=dict(cfg))
        ctrls.append(ctrl)
    return ctrls


def same_step(jctrl, pctrl, s, tol=STEP_TOL):
    """One step of each from the JAX controller's state."""
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    popt.opt_state = port_state(jopt.opt_state)
    u_ref, u = jctrl.step(s), pctrl.step(s)
    close(u, u_ref, tol, "u")
    close(popt.opt_state.plan, jopt.opt_state.plan, tol, "plan")
    for key in ("J_logged", "rollout_trajectories_logged"):
        close(popt.logging_values[key], jopt.logging_values[key], tol, key)
    assert bool(popt.logging_values["solver_ok"])


@pytest.mark.parametrize("label", list(PLANTS))
def test_one_step_over_each_plant_matches_jax(label):
    env, cost, _, attrs = PLANTS[label]
    jctrl, pctrl = pair(env, limits(env), attrs, small_config(), cost=cost)
    same_step(jctrl, pctrl, states(label, np.random.default_rng(3), 1)[0])


CARTPOLE = ("cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
            {"target_position": 0.3})
S0 = np.array([0.1, -0.2, 0.25, 0.3], np.float32)
LEARNED = {
    "fast": "ODE:rk4:1:fast",
    "mlp": f"neural:mlp-64-64:{ASSETS}",
    "gp": "SGP_16:{gp}",
    "residual": "ODE+res",
    "ensemble": f"ensemble:mlp-32-32:4:{ASSETS}",
    "value": "ODE",
}


@pytest.fixture(scope="module")
def gp_file(tmp_path_factory):
    """A seeded sparse GP of 16 points written by the JAX package: the
    committed SGP_128's posterior is ill-conditioned in float32 (its costs
    are held to float64 in chip_smoke.py), which the Jacobians of a solve
    amplify in both packages alike."""
    from control_toolkit_tpu.models.gp_predictor import GPPredictor as JaxGP
    from test_torch_plants import gp_params

    path = tmp_path_factory.mktemp("ilqr_gp") / "sgp.npz"
    JaxGP("cartpole", dt=0.02, params=gp_params(4, 1, M=16, seed=2)).save(path)
    return path


def learned_pair(kind, gp_path=None):
    jctrl, pctrl = pair(*CARTPOLE, small_config(), spec=LEARNED[kind].format(gp=gp_path))
    if kind == "residual":
        res = bench_residual(jctrl.optimizer.predictor.predictor._res)
        jctrl.optimizer.predictor.predictor.set_residual(res)
        jctrl._dyn_params = None
        pctrl.optimizer.predictor.predictor.set_residual(res)
    if kind == "value":
        attach_both(jctrl, pctrl, jax_value_net(4, hiddens=(8,)))
    return jctrl, pctrl


@pytest.mark.parametrize("kind", list(LEARNED))
def test_one_step_over_each_predictor_matches_jax(kind, gp_file):
    jctrl, pctrl = learned_pair(kind, gp_file)
    same_step(jctrl, pctrl, S0)


def test_ensemble_plans_under_the_member_mean_row_by_row():
    """The line search's 8 rows (2 x E) under the members' mean, as JAX's
    batch-1 calls: not the member blocks that ``single_step`` takes for a
    batch that E divides."""
    _, pctrl = pair(*CARTPOLE, small_config(), spec=LEARNED["ensemble"], logging=False)
    opt = pctrl.optimizer
    pred = opt.predictor.predictor
    params = pctrl._assemble_params()
    H, A = opt.mpc_horizon, len(opt.alphas)
    rng = np.random.default_rng(0)
    z0 = torch.tensor(np.append(S0, 0.1), dtype=torch.float32)
    us = torch.tensor(rng.uniform(-0.5, 0.5, (1, H, 1)), dtype=torch.float32)
    zs = opt.rollout(z0[None], us, params)
    ks = torch.tensor(rng.uniform(-0.3, 0.3, (1, H, 1)), dtype=torch.float32)
    Ks = torch.tensor(rng.uniform(-0.5, 0.5, (1, H, 1, 5)), dtype=torch.float32)
    empty = torch.zeros(1, H + 1, 0)
    _, us_c, zs_c = opt.forward_pass(z0, zs, us, ks, Ks, empty, torch.zeros(1, 0), 0.0,
                                     torch.zeros(0), params)
    x, u = zs_c[0, :, :-1, :4].reshape(A * H, 4), us_c[0].reshape(A * H, 1)
    nxt = zs_c[0, :, 1:, :4].reshape(A * H, 4)
    one_row = torch.cat([pred.single_step(x[i:i + 1], u[i:i + 1], params["dyn"])
                         for i in range(A * H)])
    close(nxt, one_row, dict(rtol=1e-5, atol=1e-6), "rows against batch-1 steps")
    rows8 = zs_c[0, :, 0, :4]
    blocks = pred.single_step(rows8, us_c[0, :, 0], params["dyn"])
    assert (blocks - zs_c[0, :, 1, :4]).abs().max() > 1e-4  # the blocks would differ


# ---- the JAX package's loops over the other plants -------------------------------------------
def test_pointmass_two_inputs_reach_the_target():
    """``tests/test_pointmass.py:174`` at its configuration and threshold."""
    ctrl = MPCController("pointmass", (np.array([-1.0, -1.0], np.float32),
                                       np.array([1.0, 1.0], np.float32)),
                         {"target_x": 1.0, "target_y": -0.5},
                         config={"device": "cpu", "optimizer": "ilqr",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="ilqr", optimizer_config={
        "seed": 2, "mpc_timestep": 0.02, "mpc_horizon": 25, "num_rollouts": 1,
        "max_iterations": 20, "tol": 1e-7, "regularization_init": 1.0,
        "regularization_max": 1e8, "line_search_steps": 6})
    env = PointMassEnv(batch_size=1, dt=0.02, seed=4)
    s, _ = env.reset()
    for _ in range(100):
        s, *_ = env.step(ctrl.step(s[0]))
    s = np.asarray(s[0])
    assert abs(s[0] - 1.0) < 0.1 and abs(s[1] + 0.5) < 0.1, f"missed target: {s}"


HOVER = {"num_rollouts": 1, "max_iterations": 20, "tol": 1e-7, "regularization_init": 1.0,
         "regularization_max": 1e8, "line_search_steps": 8}
# loop: (environment, limits, attributes, config, environment seed, ticks, the
# cost's config overrides)
LOOPS = {
    "multistart": ("pendulum", (np.array([-1.0], np.float32), np.array([1.0], np.float32)), {},
                   {"seed": 2, "mpc_timestep": 0.05, "mpc_horizon": 40, "num_rollouts": 1,
                    "max_iterations": 25, "tol": 1e-7, "regularization_init": 1.0,
                    "regularization_max": 1e8, "line_search_steps": 8, "n_starts": 6},
                   0, 80, {"energy_weight": 0.0}),
    "quadrotor2d": ("quadrotor2d", (np.zeros(2, np.float32), np.ones(2, np.float32)),
                    {"target_x": 0.0, "target_z": 1.0},
                    {"seed": 1, "mpc_timestep": 0.02, "mpc_horizon": 40, **HOVER}, 7, 200, {}),
    "quadrotor3d": ("quadrotor3d", (np.zeros(4, np.float32), np.ones(4, np.float32)),
                    {"target_x": 0.0, "target_y": 0.0, "target_z": 1.0},
                    {"seed": 1, "mpc_timestep": 0.02, "mpc_horizon": 40, **HOVER}, 7, 200, {}),
}


def loop_controller(loop, jax_side: bool):
    env, limits_, attrs, cfg, *_, cost = LOOPS[loop]
    Ctrl, extra = (JaxMPC, {}) if jax_side else (MPCController, {"device": "cpu"})
    ctrl = Ctrl(env, limits_, dict(attrs),
                config={"optimizer": "ilqr", "controller_logging": True, **extra})
    ctrl.configure(optimizer_name="ilqr", optimizer_config=dict(cfg))
    if cost:
        ctrl.cost_function.cost_function.config.update(cost)
        ctrl._cost_params = None
    return ctrl


@pytest.mark.parametrize("tick", LOOP_TICKS)
@pytest.mark.parametrize("loop", list(LOOPS))
def test_loop_steps_match_the_recorded_jax_loop(loop, tick):
    rec = np.load(GOLDEN)
    key = f"{loop}_{tick}_"
    ctrl = loop_controller(loop, jax_side=False)
    opt = ctrl.optimizer
    state = ILQRState(generator=torch.Generator(), u_traj=t(rec[key + "u_traj"]),
                      u_prev=t(rec[key + "u_prev"]), plan=t(rec[key + "plan"]),
                      j=torch.tensor(int(rec[key + "j"])), count=int(rec[key + "count"]))
    draws = t(rec[key + "draws"]) if opt.n_starts > 1 else None
    u, new_state, diag = opt.update(state, t(rec[key + "s"])[None], ctrl._assemble_params(),
                                    draws)
    close(u, rec[key + "u_out"], LOOP_TOL, "u")
    close(new_state.plan, rec[key + "plan_out"], LOOP_TOL, "plan")
    close(diag["J_logged"], rec[key + "J_out"], LOOP_TOL, "J")


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def record_loops() -> None:
    """Run the JAX loops of LOOPS, check their thresholds, and write the
    state, optimizer state, draws and outputs at LOOP_TICKS to GOLDEN."""
    from control_toolkit_tpu.environments.pendulum import PendulumEnv
    from control_toolkit_tpu.environments.quadrotor2d import Quadrotor2DEnv
    from control_toolkit_tpu.environments.quadrotor3d import Quadrotor3DEnv

    envs = {"multistart": PendulumEnv, "quadrotor2d": Quadrotor2DEnv,
            "quadrotor3d": Quadrotor3DEnv}
    out = {}
    for loop, Env in envs.items():
        ctrl = loop_controller(loop, jax_side=True)
        opt = ctrl.optimizer
        _, _, _, cfg, seed, ticks, _ = LOOPS[loop]
        env = Env(batch_size=1, dt=cfg["mpc_timestep"], seed=seed)
        env.reset()
        if loop == "multistart":
            env.state = jnp.array([[np.pi, 0.0]], jnp.float32)  # exactly hanging
        s = np.asarray(env.state)
        for tick in range(ticks):
            st = opt.opt_state
            if tick in LOOP_TICKS:
                key = f"{loop}_{tick}_"
                out.update({key + "s": s[0], key + "u_traj": st.u_traj, key + "u_prev": st.u_prev,
                            key + "plan": st.plan, key + "j": st.j, key + "count": st.count})
                if opt.n_starts > 1:
                    _, sub = jax.random.split(st.key)
                    out[key + "draws"] = jax.random.uniform(
                        sub, (opt.n_starts, opt.mpc_horizon, opt.num_control_inputs),
                        minval=opt.action_low, maxval=opt.action_high, dtype=jnp.float32)
            u = ctrl.step(s[0])
            if tick in LOOP_TICKS:
                out.update({key + "u_out": u, key + "plan_out": opt.opt_state.plan,
                            key + "J_out": opt.logging_values["J_logged"]})
            s, *_ = env.step(u)
            s = np.asarray(s)
        if loop == "multistart":
            ang = float(s[0, 0]) % (2 * np.pi)
            assert min(ang, 2 * np.pi - ang) < 0.15, f"multi-start failed to swing up: {s}"
        elif loop == "quadrotor2d":
            assert abs(s[0, 0]) < 0.1 and abs(s[0, 1] - 1.0) < 0.1 and abs(s[0, 4]) < 0.05, s
        else:
            assert np.linalg.norm(s[0, :3] - [0.0, 0.0, 1.0]) < 0.15, s
            assert abs(s[0, 6]) < 0.05 and abs(s[0, 7]) < 0.05, s
        print(loop, "final state", s[0])
    np.savez_compressed(GOLDEN, **{k: np.asarray(v, np.float32) for k, v in out.items()})


if __name__ == "__main__" and "--record" in sys.argv[1:]:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    record_loops()
