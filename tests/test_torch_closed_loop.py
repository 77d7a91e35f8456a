"""The port's closed-loop harness (``evaluation/closed_loop.py``) on the CPU.

``ClosedLoop.run`` is held bit for bit to the controller's own loop
(``controller.step`` then the environment's ``step_dynamics`` over the same
generators) for MPPI over the ODE (K2's plain version), fused CEM (K5's) and
MPPI over a GRU (K13's; the final hidden written back); actuator noise and
``reset=False`` thread as in the JAX package (tests/test_closed_loop.py);
the loop rebinds after ``configure()``; one tick of the episode is held to
the JAX ``ClosedLoop`` episode body fed the same draws and actuator noise,
to the MPPI step's parity bound (tests/test_torch_mppi.py ``UNOM_TOL``); and
MPPI stabilises the cartpole by JAX's criterion at its size.  ``run_batch``:
row n equals ``run`` of episode n alone on that episode's generator, bit for
bit, on the per-episode path and on the K4 and K7-/K1-cols sweeps (plain
versions), within an ulp-level bound on the K11-, K12- and K14-cols sweeps,
whose rows equal one-episode sweeps bit for bit, as K6's do; a stateful
predictor's episodes keep their own hiddens; ``mesh`` is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
from control_toolkit_tpu.evaluation import ClosedLoop as JaxClosedLoop
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.environments.pendulum import PendulumEnv
from control_toolkit_tpu_torch.evaluation import ClosedLoop
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from control_toolkit_tpu_torch.utils.rng import make_generator, slot_seed
from test_torch_mppi import (
    CPU, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
    set_shared_state,
)

COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
ASSETS = kernels.PACKAGE_DIR / "assets" / "cartpole"
S0 = np.array([0.0, 0.0, 0.15, 0.0], np.float32)
K, H, T = 64, 10, 8
CONFIGS = {
    "mppi": ("mppi", "ODE", optimizer_config(K, H)),
    "cem_fused": ("cem-tf", "ODE", {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H,
                                    "num_rollouts": 128, "fully_fused": True, "warmup": False,
                                    "cem_outer_it": 2, "cem_best_k": 8}),
    "gru": ("mppi", "neural:GRU-5IN-8H1-4OUT", optimizer_config(32, 8)),
    "mppi_modular": ("mppi", "ODE", optimizer_config(K, H, semi_fused=False)),
    "mppi_var": ("mppi-var-tf", "ODE", {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H,
                                        "num_rollouts": K}),
    "rpgd": ("rpgd-tf", "ODE", {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H,
                                "num_rollouts": 32, "outer_its": 2, "warmup": False,
                                "period_interpolation_inducing_points": 5}),
    "gradient": ("gradient-tf", "ODE", {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H,
                                        "num_rollouts": 32, "gradient_steps": 2,
                                        "warmup": False}),
    "neural": ("mppi", f"neural:mlp-64-64:{ASSETS}", optimizer_config(32, 8)),
    "residual": ("mppi", "ODE+res", optimizer_config(32, 8)),
    "gp": ("mppi", f"SGP_128:{ASSETS}/SGP_128.npz", optimizer_config(32, 8)),
    "cem_modular": ("cem-tf", "ODE", {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H,
                                      "num_rollouts": 32, "warmup": False, "cem_outer_it": 2,
                                      "cem_best_k": 8}),
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def controller(case: str, env_name: str = "cartpole", **overrides) -> MPCController:
    optimizer, spec, cfg = CONFIGS[case]
    ctrl = MPCController(env_name, LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "device": "cpu",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=dict(cfg, **overrides),
                   cost_function_config=None if env_name != "cartpole" else COST_WEIGHTS)
    if case == "cem_fused":
        # K5's tile at the test's K (tests/test_torch_cem.py).
        ctrl.optimizer.fused_tile_k = 64
        ctrl.optimizer._build()
        assert ctrl.optimizer._fused
    return ctrl


def reference_loop(ctrl, env, s0, ticks, noise=None, scale=0.0):
    """The controller's own loop: ``controller.step`` on the host state, the
    actuator noise, the clip and the environment's ``step_dynamics``."""
    low, high = torch.as_tensor(env.action_low), torch.as_tensor(env.action_high)
    s, states, controls = torch.as_tensor(s0)[None], [], []
    for t in range(ticks):
        u = torch.as_tensor(ctrl.step(s[0].numpy()))[None]
        if noise is not None:
            u = u + scale * noise[t][None]
        u = torch.clamp(u, low, high)
        states.append(s[0])
        controls.append(u[0])
        s = env.step_dynamics(s, u, env.dt)
    return torch.stack(states).numpy(), torch.stack(controls).numpy(), s[0].numpy()


@pytest.mark.parametrize("case", ["mppi", "cem_fused", "gru"])
def test_run_equals_the_controllers_own_loop(case):
    """``run`` against ``controller.step`` plus ``step_dynamics``, both from
    a fresh optimizer on the same generator and the same actuator noise:
    states, controls and final state bit for bit; a GRU's final hidden is
    written back, equal to the reference predictor's."""
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=3)
    scale = 0.05
    ref = controller(case)
    noise = torch.randn((T, 1), generator=make_generator(4, CPU))
    states, controls, final = reference_loop(ref, env, S0, T, noise, scale)
    loop = ClosedLoop(controller(case), env, actuator_noise=scale, noise_seed=4)
    out = loop.run(S0, T)
    np.testing.assert_array_equal(out["states"], states)
    np.testing.assert_array_equal(out["controls"], controls)
    np.testing.assert_array_equal(out["final_state"], final)
    assert out["stage_costs"].shape == (T,) and np.isfinite(out["mean_cost"])
    if case == "gru":
        written = loop.optimizer.predictor.predictor.hidden
        for h, h_ref in zip(written, ref.optimizer.predictor.predictor.hidden):
            assert torch.equal(h, h_ref) and torch.any(h != 0.0)


def test_actuator_noise_and_state_threading():
    """JAX's test_actuator_noise_and_state_threading on the port: a second
    episode draws fresh noise; the same noise seed repeats an episode bit
    for bit; ``reset=False`` carries the warm start (a reset episode on the
    same noise differs)."""
    s0 = np.array([np.pi * 0.9, 0.0], np.float32)

    def make_loop():
        return ClosedLoop(controller("mppi", "pendulum"), PendulumEnv(batch_size=1, dt=0.02,
                                                                      seed=2),
                          actuator_noise=0.05, noise_seed=4)

    loop1 = make_loop()
    a = loop1.run(s0, 10)
    b = loop1.run(s0, 10, reset=False)
    assert not np.allclose(a["controls"], b["controls"])
    loop2 = make_loop()
    a2 = loop2.run(s0, 10)
    np.testing.assert_array_equal(a2["controls"], a["controls"])
    d = loop2.run(s0, 10)
    assert not np.allclose(b["controls"], d["controls"])
    assert np.all(np.isfinite(b["states"])) and np.all(np.isfinite(d["states"]))


def test_reset_false_continues_the_episode():
    """Two episodes of T/2 ticks with ``reset=False``, each from where the
    last ended, equal one episode of T ticks bit for bit (no actuator
    noise)."""
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=3)
    whole = ClosedLoop(controller("mppi"), env).run(S0, T)
    loop = ClosedLoop(controller("mppi"), env)
    first = loop.run(S0, T // 2)
    second = loop.run(first["final_state"], T // 2, reset=False)
    np.testing.assert_array_equal(np.concatenate([first["controls"], second["controls"]]),
                                  whole["controls"])
    np.testing.assert_array_equal(second["final_state"], whole["final_state"])


def test_loop_rebinds_after_configure():
    """A reconfigure (a new optimizer, another horizon) reaches an existing
    loop: it evaluates the new objective, as a fresh loop over the
    reconfigured controller does."""
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=0)
    ctrl = controller("mppi")
    loop = ClosedLoop(ctrl, env)
    before = loop.run(S0, 4)
    epoch = loop._opt_epoch
    ctrl.configure(optimizer_name="mppi", optimizer_config=optimizer_config(K, 6, LBD=10.0),
                   cost_function_config=COST_WEIGHTS)
    after = loop.run(S0, 4)
    assert loop.optimizer is ctrl.optimizer and loop.optimizer.mpc_horizon == 6
    assert not np.array_equal(before["controls"], after["controls"])
    np.testing.assert_array_equal(after["controls"], ClosedLoop(ctrl, env).run(S0, 4)["controls"])
    ctrl.optimizer._build()  # a rebuild alone (attach_value_terminal's)
    loop.run(S0, 1)
    assert loop._opt_epoch != epoch


def test_one_tick_matches_the_jax_episode_body():
    """One tick of the port's episode against the JAX ``ClosedLoop``'s
    episode body (``_episode``, eager) from the same optimizer state, fed the
    same draw (JAX's next [K, P, U] normals) and the same actuator noise
    (JAX's normal from the tick's key): the applied control, the stage cost
    and the next state, to the MPPI step's bound (UNOM_TOL)."""
    cfg = optimizer_config(K, H)
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.0},
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", optimizer_config=cfg)
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                          config={"optimizer": "mppi", "device": "cpu",
                                  "controller_logging": False})
    pctrl.configure(optimizer_name="mppi", optimizer_config=cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_shared_state(jopt, popt)
    scale = 0.1
    jloop = JaxClosedLoop(jctrl, JaxCartpoleEnv(batch_size=1, dt=0.02, seed=0),
                          actuator_noise=scale)
    ploop = ClosedLoop(pctrl, CartpoleEnv(batch_size=1, dt=0.02, seed=0), actuator_noise=scale)
    key = jax.random.split(jax.random.PRNGKey(11), 1)
    jnoise = np.asarray(jax.random.normal(key[0], (1,)))
    delta = jax_next_draw(jopt)
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                     jctrl._assemble_params())
    _, jsT, _, jus, jstage, _ = jloop._episode(jopt.opt_state, jnp.asarray(S0), jparams, key, 1)

    popt.sample_noise = lambda state: port_noise(popt, delta)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    _, sT, _, us, stage, _ = ploop._episode(popt.opt_state, torch.as_tensor(S0), params,
                                            torch.tensor(jnoise)[None], 1)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), **UNOM_TOL)
    np.testing.assert_allclose(stage.numpy(), np.asarray(jstage), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sT.numpy(), np.asarray(jsT), **UNOM_TOL)


def test_stabilizes_cartpole():
    """JAX's test_stabilizes_cartpole at its size: MPPI (K=512, H=25,
    SQRTRHOINV 0.03, seed 7) holds the pole within 0.15 rad after 80 ticks
    from CartpoleEnv(seed=1)'s start."""
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=1)
    ctrl = controller("mppi", mpc_horizon=25, num_rollouts=512, SQRTRHOINV=0.03, seed=7)
    s0, _ = env.reset()
    out = ClosedLoop(ctrl, env).run(s0[0], 80)
    assert abs(out["final_state"][2]) < 0.15, out["final_state"]
    assert np.all(np.isfinite(out["states"]))


SWEEP_KINDS = {"mppi": "ode", "mppi_var": "mppi-var", "cem_fused": "cem-fused", "rpgd": "rpgd",
               "gradient": "gradient", "neural": "neural", "residual": "residual", "gp": "gp",
               "mppi_modular": None, "cem_modular": None, "gru": None}


# The learned models' session-row steps take the weighted average as one
# einsum over [B, K, H, U] (MPPIOptimizer._batched_columns_step_from_kernel),
# the single session's step over its own K rows: the same function, an ulp
# or two apart.
LEARNED_ROW_TOL = dict(rtol=1e-6, atol=1e-6)


def one_episode_sweep(loop, kind, s0, n, ticks):
    """Episode n alone on the kernel sweep of ``kind`` (N=1), from the
    generator ``slot_seed(seed, n)``."""
    from control_toolkit_tpu_torch.controllers.batched_mpc import _stack_states

    opt = loop.optimizer
    states = _stack_states([opt._init_state(make_generator(slot_seed(opt._seed, n), CPU))])
    sT, ss, us, stage = loop._kernel_episodes(loop._kernel_step(kind, 1), states,
                                              torch.as_tensor(s0[None]),
                                              loop.controller._assemble_params(), None, ticks)
    return {"states": ss[0].numpy(), "controls": us[0].numpy(),
            "stage_costs": stage[0].numpy(), "final_state": sT[0].numpy()}


def assert_row(out, n, ref, **tol):
    check = (np.testing.assert_allclose if tol else np.testing.assert_array_equal)
    check(out["states"][n], ref["states"], **tol)
    check(out["controls"][n], ref["controls"], **tol)
    check(out["stage_costs"][n], ref["stage_costs"], **tol)
    check(out["final_states"][n], ref["final_state"], **tol)


@pytest.mark.parametrize("case", sorted(SWEEP_KINDS))
def test_run_batch_rows_equal_run_of_each_episode(case):
    """Each configuration takes the sweep its fleet gate admits (modular
    MPPI and CEM and a GRU: the per-episode path), and row n of a
    3-episode sweep equals ``run`` of episode n alone from the generator
    ``slot_seed(seed, n)``: states, controls, stage costs, bit for bit (the
    MPPI, mppi-var, RPGD and gradient-tf sweeps and the per-episode path),
    within LEARNED_ROW_TOL for the learned models' sweeps (each row also
    equal bit for bit to a one-episode sweep: the sweep does not depend on
    N).  Fused CEM's sweep is K6, whose counters are laid out by session and
    not as K5's tiles (as in JAX): its rows are held to one-episode sweeps."""
    ctrl = controller(case)
    loop = ClosedLoop(ctrl, CartpoleEnv(batch_size=1, dt=0.02, seed=0))
    kind = SWEEP_KINDS[case]
    assert loop._sweep_kind() == kind
    s0s = np.random.default_rng(5).uniform(-0.1, 0.1, (3, 4)).astype(np.float32)
    ticks = 2
    out = loop.run_batch(s0s, ticks, return_trajectories=True)
    opt = ctrl.optimizer
    for n in range(3):
        if kind in ("cem-fused", "neural", "residual", "gp"):
            assert_row(out, n, one_episode_sweep(loop, kind, s0s[n], n, ticks))
            if kind == "cem-fused":
                continue
        opt.opt_state = opt._init_state(make_generator(slot_seed(opt._seed, n), CPU))
        if case == "gru":
            opt.predictor.predictor.reset_state()
        ref = loop.run(s0s[n], ticks, reset=False)
        assert_row(out, n, ref, **(LEARNED_ROW_TOL if kind in ("neural", "residual", "gp")
                                   else {}))
        if case == "gru":
            for h, h_ref in zip(out["final_hidden"], opt.predictor.predictor.hidden):
                np.testing.assert_array_equal(h[n], h_ref.numpy())
    np.testing.assert_array_equal(out["mean_costs"], out["stage_costs"].mean(axis=1))


def test_run_batch_leaves_the_live_state_and_draws_its_own_noise():
    """The controller's live state is untouched; each episode has its own
    actuator noise (two episodes from one start differ); the sweep's shapes;
    ``mesh`` is refused, naming A10; a non-[N, S] start is a ValueError."""
    ctrl = controller("mppi")
    loop = ClosedLoop(ctrl, CartpoleEnv(batch_size=1, dt=0.02, seed=0), actuator_noise=0.1)
    live = ctrl.optimizer.opt_state
    gen_state = live.generator.get_state()
    out = loop.run_batch(np.tile(S0, (2, 1)), 3, return_trajectories=True)
    assert ctrl.optimizer.opt_state is live and torch.equal(live.generator.get_state(), gen_state)
    assert out["states"].shape == (2, 3, 4) and out["controls"].shape == (2, 3, 1)
    assert out["stage_costs"].shape == (2, 3) and out["final_states"].shape == (2, 4)
    assert not np.array_equal(out["controls"][0], out["controls"][1])
    with pytest.raises(NotImplementedError, match="A10"):
        loop.run_batch(np.tile(S0, (2, 1)), 3, mesh=object())
    with pytest.raises(ValueError, match=r"\[N, S\]"):
        loop.run_batch(S0, 3)
