"""The torch port's gradient optimizers (RPGD and its variants, gradient-tf)
and their shared ops against the JAX package.

Both packages start from the same state, made with numpy from a seed, and
get the same random numbers: the JAX draws are taken by re-splitting the
JAX optimizer's key exactly as its step does (optimizers/rpgd.py:406-410,
optimizers/gradient.py:239-242) and fed to the port's ``update(state, s,
params, draw)``.  On the CPU the JAX step differentiates its rollout with
``jax.grad``; the port's takes K7's and K1's plain versions (hand-written
adjoints).  The JAX controllers log, so their Adam-loop population and
costs can be read.  Parity is per step: no test compares long loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.ops import common as jcommon
from control_toolkit_tpu_torch import import_controller_by_name, import_optimizer_by_name
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops import common
from control_toolkit_tpu_torch.ops.grad_cost_rollout import grad_cost_rollout
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.optimizers.gradient import GradientOptimizer
from control_toolkit_tpu_torch.optimizers.rpgd import (
    RPGDOptimizer, rpgd_keep_surgery, rpgd_resample_surgery,
)
from control_toolkit_tpu_torch.utils.convert import (
    gradient_state_from_numpy, params_from_numpy, rpgd_state_from_numpy,
)
from test_torch_mppi import CPU, LIMITS, jax_params_numpy

K, H = 128, 15
GOLDEN_PATH = "golden/cartpole_golden.npz"
# Costs: K1's bounds (float32 sums over 15 rk4 steps).  The population
# after the Adam loop: two Keras-Adam steps of lr 0.05 whose gradients agree
# to the gradient kernel's bounds (test_torch_grad.py).
COST_TOL = dict(rtol=3e-5, atol=1e-4)
Q_TOL = dict(rtol=1e-5, atol=1e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rpgd_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "outer_its": 2, "SAMPLING_DISTRIBUTION": "uniform",
           "period_interpolation_inducing_points": 5, "learning_rate": 0.05,
           "gradmax_clip": 5, "opt_keep_k_ratio": 0.25, "resamp_per": 10,
           "sample_stdev": 0.5, "warmup": False, "warmup_iterations": 3}
    cfg.update(extra)
    return cfg


def gradient_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "gradient_steps": 3, "learning_rate": 0.05, "gradmax_clip": 5,
           "warmup_iterations": 4}
    cfg.update(extra)
    return cfg


def make_pair(name, cfg):
    """The JAX controller (logging on) and the port's (logging off: the
    kernel path) over the same optimizer config."""
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                   config={"optimizer": name, "controller_logging": True})
    jctrl.configure(optimizer_name=name, optimizer_config=dict(cfg))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": name, "controller_logging": False})
    pctrl.configure(optimizer_name=name, optimizer_config=dict(cfg))
    return jctrl, pctrl


def shared_population(jopt, seed):
    rng = np.random.default_rng(seed)
    shape = (jopt.num_rollouts, jopt.mpc_horizon, jopt.num_control_inputs)
    return {
        "Q": rng.uniform(-1.0, 1.0, shape).astype(np.float32),
        "m": (0.05 * rng.standard_normal(shape)).astype(np.float32),
        "v": (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32),
        "adam_step": 4,
        "u_prev": np.array([0.2], np.float32),
    }


def jax_adam(st):
    return jcommon.AdamState(step=jnp.int32(st["adam_step"]), m=jnp.asarray(st["m"]),
                             v=jnp.asarray(st["v"]))


def set_rpgd_state(jopt, popt, count, seed=0):
    st = shared_population(jopt, seed)
    ages = np.random.default_rng(seed + 1).integers(0, 20, jopt.num_rollouts).astype(np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        Q=jnp.asarray(st["Q"]), adam=jax_adam(st), trajectory_ages=jnp.asarray(ages),
        count=jnp.int32(count), u_prev=jnp.asarray(st["u_prev"]))
    popt.opt_state = rpgd_state_from_numpy(st["Q"], st["m"], st["v"], st["adam_step"], ages,
                                           count, st["u_prev"], popt.opt_state.generator)


def jax_resample_key(jopt):
    _, sub = jax.random.split(jopt.opt_state.key)
    return sub


def jax_rpgd_draw(jopt):
    """The [n, P, U] inducing-point controls the JAX step draws on a
    resample tick (rpgd.py:_sample_actions)."""
    n = jopt.num_rollouts - jopt.opt_keep_k
    shape = (n, jopt.interp.number_of_interpolation_inducing_points, jopt.num_control_inputs)
    if jopt.sampling_distribution == "normal":
        return np.array(jopt.sample_mean + jopt.sample_stdev * jax.random.normal(
            jax_resample_key(jopt), shape, jnp.float32))
    return np.array(jax.random.uniform(jax_resample_key(jopt), shape, minval=jopt.action_low,
                                       maxval=jopt.action_high, dtype=jnp.float32))


def port_params(jctrl):
    return params_from_numpy(jax_params_numpy(jctrl), CPU)


def assert_rpgd_states_match(jopt, state, diag, u, u_jax):
    js, jlog = jopt.opt_state, jopt.logging_values
    np.testing.assert_allclose(diag["J_logged"].numpy(), jlog["J_logged"], **COST_TOL)
    np.testing.assert_allclose(diag["Q_logged"].numpy(), jlog["Q_logged"], **Q_TOL)
    assert state.count == int(js.count) and state.adam.step == int(js.adam.step)
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(state.adam.v.numpy(), np.asarray(js.adam.v), **MOMENT_TOL)
    np.testing.assert_array_equal(state.trajectory_ages.numpy(), np.asarray(js.trajectory_ages))
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)
    np.testing.assert_array_equal(state.u_prev.numpy(), u.numpy())


# ---- shared ops -------------------------------------------------------------
def test_common_ops_match_jax():
    rng = np.random.default_rng(0)
    t = (3.0 * rng.standard_normal((16, 10, 2))).astype(np.float32)
    for clip in (0.5, 5.0, 1e3):
        np.testing.assert_allclose(common.clip_by_norm(torch.as_tensor(t), clip, (1, 2)).numpy(),
                                   np.asarray(jcommon.clip_by_norm(jnp.asarray(t), clip, (1, 2))),
                                   rtol=1e-6, atol=1e-7)
    costs = rng.permutation(200).astype(np.float32) * 0.37  # distinct: no ties
    np.testing.assert_array_equal(common.elite_indices(torch.as_tensor(costs), 17).numpy(),
                                  np.asarray(jcommon.elite_indices(jnp.asarray(costs), 17)))
    m = (0.1 * rng.standard_normal(t.shape)).astype(np.float32)
    v = rng.uniform(1e-6, 1e-2, t.shape).astype(np.float32)
    jst = jcommon.AdamState(step=jnp.int32(6), m=jnp.asarray(m), v=jnp.asarray(v))
    pst = common.AdamState(step=6, m=torch.as_tensor(m), v=torch.as_tensor(v))
    for eps in (1e-8, 1e-7):
        jst2, jdelta = jcommon.adam_update(jst, jnp.asarray(t), 0.05, 0.9, 0.999, eps)
        pst2, pdelta = common.adam_update(pst, torch.as_tensor(t), 0.05, 0.9, 0.999, eps)
        assert pst2.step == int(jst2.step) == 7
        np.testing.assert_allclose(pdelta.numpy(), np.asarray(jdelta), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(pst2.v.numpy(), np.asarray(jst2.v), rtol=1e-6, atol=1e-12)
    shifted = common.shift_adam_moments(pst)
    jshifted = jcommon.shift_adam_moments(jst)
    np.testing.assert_array_equal(shifted.m.numpy(), np.asarray(jshifted.m))
    np.testing.assert_array_equal(shifted.v.numpy(), np.asarray(jshifted.v))
    assert shifted.step == 6


def test_surgery_matches_jax_and_tf_fixture():
    from pathlib import Path

    from control_toolkit_tpu.optimizers import rpgd as jrpgd

    g = np.load(Path(__file__).parent / GOLDEN_PATH)
    best = common.elite_indices(torch.as_tensor(g["rpgd_costs"]), int(g["rpgd_keep_k"]))
    np.testing.assert_array_equal(best.numpy(), g["rpgd_best_idx"])
    args = [torch.as_tensor(g[k]) for k in ("rpgd_Qn", "rpgd_m", "rpgd_v", "rpgd_ages")]
    got = rpgd_resample_surgery(*args, best, torch.as_tensor(g["rpgd_Qres"]))
    ref = jrpgd.rpgd_resample_surgery(*map(jnp.asarray, (g["rpgd_Qn"], g["rpgd_m"], g["rpgd_v"],
                                                          g["rpgd_ages"])),
                                      jnp.asarray(best.numpy()), jnp.asarray(g["rpgd_Qres"]))
    for name, a, b in zip(("Q_after", "m_after", "v_after", "ages_after"), got, ref):
        np.testing.assert_array_equal(a.numpy(), g[f"rpgd_{name}"])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m_s, v_s = rpgd_keep_surgery(torch.as_tensor(g["rpgd_m"]), torch.as_tensor(g["rpgd_v"]))
    np.testing.assert_array_equal(m_s.numpy(), g["rpgd_m_shift"])
    np.testing.assert_array_equal(v_s.numpy(), g["rpgd_v_shift"])


# ---- one RPGD update --------------------------------------------------------
@pytest.mark.parametrize("name,extra,count", [
    ("rpgd-tf", {}, 10),                                   # resample tick
    ("rpgd-tf", {}, 7),                                    # keep tick
    ("rpgd-tf", {"warmup": True}, 0),                      # warmup: 3 Adam steps
    ("rpgd-tf", {"SAMPLING_DISTRIBUTION": "normal"}, 20),
    ("rpgd-ml-tf", {"maximum_entropy_alpha": 0.1}, 10),
])
def test_one_rpgd_update_matches_jax(name, extra, count):
    jctrl, pctrl = make_pair(name, rpgd_config(**extra))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ode.can_use_grad(popt)
    set_rpgd_state(jopt, popt, count)
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    draw = torch.as_tensor(jax_rpgd_draw(jopt)) if count % 10 == 0 else None
    u_jax = jctrl.step(s)
    before = grad_cost_rollout.launches
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], port_params(jctrl), draw)
    assert grad_cost_rollout.launches == before  # CPU tensors: the plain version
    assert_rpgd_states_match(jopt, state, diag, u, u_jax)


def test_particle_update_matches_jax_with_its_draw():
    """The port picks the population indices from uniforms by inverse CDF.
    Fed, for each of JAX's categorical indices, the midpoint of that index's
    interval of the cumulative weights (from JAX's costs), it picks JAX's
    indices, and the update then matches JAX's."""
    jctrl, pctrl = make_pair("rpgd-particle-tf", rpgd_config(particle_temperature=50.0))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_rpgd_state(jopt, popt, count=10, seed=2)
    kc, kj = jax.random.split(jax_resample_key(jopt))
    s = np.array([0.0, 0.1, -0.1, 0.0], np.float32)
    u_jax = jctrl.step(s)
    # The draw rpgd.py:_resample made from the tick's costs.
    cost = jnp.asarray(jopt.logging_values["J_logged"])
    n = K - jopt.opt_keep_k
    idx = np.array(jax.random.categorical(
        kc, -(cost - jnp.min(cost)) / jopt.particle_temperature, shape=(n,)))
    jitter = jopt.sample_stdev * jax.random.normal(
        kj, (n, jopt.interp.number_of_interpolation_inducing_points, 1), jnp.float32)
    c64 = np.asarray(cost, np.float64)
    w = np.exp(-(c64 - c64.min()) / jopt.particle_temperature)
    cdf = np.concatenate([[0.0], np.cumsum(w / w.sum())])
    uniforms = torch.tensor(0.5 * (cdf[idx] + cdf[idx + 1]), dtype=torch.float32)
    np.testing.assert_array_equal(popt.pick(torch.tensor(np.array(cost)), uniforms).numpy(),
                                  idx)
    draw = (uniforms, torch.tensor(np.array(jitter)))
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], port_params(jctrl), draw)
    assert_rpgd_states_match(jopt, state, diag, u, u_jax)
    # The port's own draw: n uniforms in [0, 1) and the jitter.
    uni, jit = popt.sample_resample(state._replace(count=20))
    assert uni.shape == (n,) and float(uni.min()) >= 0.0 and float(uni.max()) < 1.0
    assert jit.shape == (n, jopt.interp.number_of_interpolation_inducing_points, 1)


def test_update_refuses_a_draw_on_the_wrong_tick():
    _, pctrl = make_pair("rpgd-tf", rpgd_config(num_rollouts=32, mpc_horizon=8))
    popt = pctrl.optimizer
    s, params = torch.zeros(1, 4), pctrl._assemble_params()
    assert popt.sample_resample(popt.opt_state) is not None  # tick 0 resamples
    with pytest.raises(ValueError, match="resample"):
        popt.update(popt.opt_state, s, params, None)
    keep = popt.opt_state._replace(count=3)
    assert popt.sample_resample(keep) is None
    with pytest.raises(ValueError, match="resample"):
        popt.update(keep, s, params, torch.zeros(24, 2, 1))


# ---- one gradient-tf update -------------------------------------------------
@pytest.mark.parametrize("extra,count", [({}, 5), ({"warmup": True}, 0)])
def test_one_gradient_update_matches_jax(extra, count):
    jctrl, pctrl = make_pair("gradient-tf", gradient_config(**extra))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt.adam_epsilon == 1e-7
    st = shared_population(jopt, seed=4)
    jopt.opt_state = jopt.opt_state._replace(Q=jnp.asarray(st["Q"]), adam=jax_adam(st),
                                             count=jnp.int32(count),
                                             u_prev=jnp.asarray(st["u_prev"]))
    popt.opt_state = gradient_state_from_numpy(st["Q"], st["m"], st["v"], st["adam_step"], count,
                                               st["u_prev"], popt.opt_state.generator)
    tail = np.array(jax.random.uniform(jax_resample_key(jopt), (K, 1, 1),
                                       minval=jopt.action_low, maxval=jopt.action_high,
                                       dtype=jnp.float32))
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], port_params(jctrl),
                                 torch.as_tensor(tail))
    js = jopt.opt_state
    np.testing.assert_allclose(diag["J_logged"].numpy(), jopt.logging_values["J_logged"],
                               **COST_TOL)
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_array_equal(state.Q[:, -1:].numpy(), tail)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(state.adam.v.numpy(), np.asarray(js.adam.v), **MOMENT_TOL)
    assert state.adam.step == int(js.adam.step) and state.count == int(js.count)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


# ---- the controller ---------------------------------------------------------
def test_controller_ticks_match_jax():
    """Three ticks (a resample tick, then two keep ticks) through both
    controllers' step(), each fed the same plant state and the same draw;
    the populations carry over from tick to tick."""
    jctrl, pctrl = make_pair("rpgd-tf", rpgd_config())
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_rpgd_state(jopt, popt, count=0, seed=5)
    captured = []
    step_fn = popt._step_fn
    popt._step_fn = lambda st, s, p: captured.append(step_fn(st, s, p)) or captured[-1]
    rng = np.random.default_rng(6)
    for _ in range(3):
        s = (0.05 * rng.standard_normal(4)).astype(np.float32)
        draw = jax_rpgd_draw(jopt) if int(jopt.opt_state.count) % 10 == 0 else None
        popt.sample_resample = lambda state, d=draw: None if d is None else torch.as_tensor(d)
        u_jax = jctrl.step(s)
        u_port = pctrl.step(s)
        jcost = jopt.logging_values["J_logged"]
        pcost = captured[-1][2]["J_logged"].numpy()
        np.testing.assert_allclose(pcost, jcost, **COST_TOL)
        jbest, pbest = int(np.argmin(jcost)), int(np.argmin(pcost))
        if jbest == pbest:
            np.testing.assert_allclose(u_port, u_jax, **Q_TOL)
        else:  # a tie within the cost tolerance
            np.testing.assert_allclose(jcost[pbest], jcost[jbest], **COST_TOL)
    assert popt.opt_state.count == int(jopt.opt_state.count) == 3


@pytest.mark.parametrize("name,cfg", [("rpgd-tf", rpgd_config(resamp_per=2)),
                                      ("gradient-tf", gradient_config())])
def test_logging_contract_shapes_match_jax(name, cfg):
    cfg = dict(cfg, num_rollouts=32, mpc_horizon=10)
    jctrl, _ = make_pair(name, cfg)
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": name, "controller_logging": True})
    pctrl.configure(optimizer_name=name, optimizer_config=dict(cfg))
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    for _ in range(3):
        jctrl.step(s)
        pctrl.step(s)
    jout, pout = jctrl.get_outputs(), pctrl.get_outputs()
    assert set(pout) == set(jout)
    for key in jout:
        if jout[key] is None:
            assert pout[key] is None, key
        else:
            assert pout[key].shape == jout[key].shape, key


def test_gradient_path_gate_and_autograd_fallback():
    """K7 serves the gradient when logging is off; force_scan and logging
    take torch.autograd through the fused loop or the trajectory, and all
    three agree."""
    cfg = rpgd_config(num_rollouts=64, mpc_horizon=10)
    _, kernel_ctrl = make_pair("rpgd-tf", cfg)
    _, scan_ctrl = make_pair("rpgd-tf", dict(cfg, force_scan=True))
    log_ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                             config={"device": "cpu",
                                     "optimizer": "rpgd-tf", "controller_logging": True})
    log_ctrl.configure(optimizer_name="rpgd-tf", optimizer_config=dict(cfg))
    assert ode.can_use_grad(kernel_ctrl.optimizer)
    assert not ode.can_use_grad(scan_ctrl.optimizer)
    rng = np.random.default_rng(7)
    s_tiled = torch.as_tensor(np.tile((0.1 * rng.standard_normal((1, 4))).astype(np.float32),
                                      (64, 1)))
    Q = torch.as_tensor(rng.uniform(-1.0, 1.0, (64, 10, 1)).astype(np.float32))
    u_prev, params = torch.tensor([0.1]), kernel_ctrl._assemble_params()
    grads = []
    for ctrl, has_cost_only in ((kernel_ctrl, True), (scan_ctrl, True), (log_ctrl, False)):
        grad_fn, cost_only = ctrl.optimizer._make_grad_and_cost_only()
        assert (cost_only is not None) == has_cost_only
        grads.append(grad_fn(Q, s_tiled, u_prev, params))
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(grads[2], grads[0], rtol=1e-4, atol=2e-4)


def test_registered_names_resolve_and_batched_steps_raise():
    """The names resolve; the batched steps build (tests/test_torch_fleet_grad.py
    holds them to the JAX package's) and, with warmup on, raise; the policy
    warm start raises."""
    names = ("rpgd-tf", "rpgd", "dist-adam-resamp2-tf", "rpgd-me-tf", "rpgd-me-param-tf",
             "rpgd-ml-tf", "rpgd-particle-tf", "gradient-tf", "gradient")
    for name in names:
        cls = import_optimizer_by_name(name)
        assert issubclass(cls, (RPGDOptimizer, GradientOptimizer))
        assert cls.registered_name in names
        assert import_controller_by_name(name) is MPCController
    _, rctrl = make_pair("rpgd-tf", rpgd_config(num_rollouts=32, mpc_horizon=8))
    _, gctrl = make_pair("gradient-tf", gradient_config(num_rollouts=32, mpc_horizon=8))
    for build in (rctrl.optimizer._make_batched_rpgd_step,
                  gctrl.optimizer._make_batched_gradient_step):
        step, update = build(2)
        assert callable(step) and callable(update)
    for opt, build in ((rctrl.optimizer, rctrl.optimizer._make_batched_rpgd_step),
                       (gctrl.optimizer, gctrl.optimizer._make_batched_gradient_step)):
        opt.warmup = True
        with pytest.raises(NotImplementedError, match="warmup=False"):
            build(2)
        opt.warmup = False
    with pytest.raises(NotImplementedError):
        rctrl.optimizer._apply_policy_guess(rctrl.optimizer.opt_state, None)
    with pytest.raises(NotImplementedError):
        make_pair("rpgd-tf", rpgd_config(initial_guess_policy="zero"))
