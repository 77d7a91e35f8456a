"""The port's CEM (``optimizers/cem.py``) and K5 (``ops/fused_cem.py``)
against the JAX package.

K5's plain version is held to the JAX kernel ``build_fused_cem`` in
interpret mode (K=256, H=20, tile 128, as tests/test_pallas_cem.py) with
the same seed2: costs to rtol 3e-5 (float32 sums over 20 rk4 steps; the
normals differ by an ulp of log or cos), the regenerated controls to
1e-6.  One CEM step of each path is fed JAX's draws (the modular path's
normals, the fused path's seeds, re-split from the JAX key as its step
splits it): mue, std, u and the best elite to UNOM_TOL.  The step of K1,
K5 and K6 (csrc/short_step.cuh: derivs_short's reciprocals) is transcribed
in float32 and held to the plain version's bound, which rejects K1's
controls read one step early or from the next rollout's row.  On a
machine with a card, K5 is held to its plain version and equals K1 over
its regenerated controls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.fused_cem import (
    fused_cem_costs, fused_cem_costs_plain, regen_controls,
)
from control_toolkit_tpu_torch.ops.neural_rollout import plain_cost_loop
from control_toolkit_tpu_torch.ops.soa_integrators import make_soa_stepper
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, COST_TOL, LIMITS, UNOM_TOL

K, H, TILE = 256, 20, 128
# Costs of the same controls: float32 sums over 20 rk4 steps, each side's
# own log/cos; the controls themselves agree to an ulp of the normals.
K5_TOL = dict(rtol=3e-5, atol=1e-4)
Q_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cem_config(K=K, H=H, **extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
           "cem_best_k": 32, "warmup": False, "warmup_iterations": 2, "fully_fused": False}
    cfg.update(extra)
    return cfg


def make_pair(optimizer="cem-tf", limits=LIMITS, **cfg):
    """The JAX and port controllers of one configuration."""
    jctrl = JaxMPC("cartpole", limits, {"target_position": 0.1},
                   config={"optimizer": optimizer, "controller_logging": False})
    jctrl.configure(optimizer_name=optimizer, optimizer_config=cfg)
    pctrl = MPCController("cartpole", limits, {"target_position": 0.1},
                          config={"device": "cpu",
                                  "optimizer": optimizer, "controller_logging": False})
    pctrl.configure(optimizer_name=optimizer, optimizer_config=cfg)
    return jctrl, pctrl


def both_params(jctrl):
    tree = jctrl._assemble_params()
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), CPU))


@pytest.fixture(scope="module")
def pair():
    jctrl, pctrl = make_pair(**cem_config())
    return (jctrl, pctrl) + both_params(jctrl)


def k5_inputs(seed2):
    s0 = np.array([0.1, -0.05, 0.25, 0.1], np.float32)
    mue = np.linspace(-0.3, 0.3, H, dtype=np.float32).reshape(H, 1)
    std = np.full((H, 1), 0.4, np.float32)
    return s0, mue, std, np.array([0.2], np.float32), np.asarray(seed2, np.int32)


@pytest.mark.parametrize("seed2", [(77, 0), (2**31 - 2, 0), (123456, 7)])
def test_k5_plain_matches_pallas_interpret(pair, seed2):
    """Costs in the JAX kernel's ``costs2d.reshape(-1)`` order; a large
    seed wraps seed*FNV, a tile offset shifts every tile's counters."""
    jctrl, pctrl, jparams, params = pair
    run, regen, jpack = jctrl.optimizer._build_fused_cem(interpret=True, tile_k=TILE)
    s0, mue, std, u_prev, sd = k5_inputs(seed2)
    ref = np.asarray(run(jnp.asarray(s0), jnp.asarray(mue), jnp.asarray(std),
                         jpack(jparams, jnp.asarray(u_prev)), jnp.asarray(sd))).reshape(-1)
    popt = pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    got = fused_cem_costs(model, torch.tensor(s0), torch.tensor(mue), torch.tensor(std),
                          pack(params, torch.tensor(u_prev)), torch.tensor(sd), popt.action_low,
                          popt.action_high, K, TILE).numpy()
    np.testing.assert_allclose(got, ref, **K5_TOL)


def test_regen_controls_match_jax_regen(pair):
    jctrl, pctrl, _, _ = pair
    _, regen, _ = jctrl.optimizer._build_fused_cem(interpret=True, tile_k=TILE)
    s0, mue, std, _, sd = k5_inputs((5, 0))
    std = 2.0 * std  # heavy clipping: both bounds reached
    idx = np.random.default_rng(0).permutation(K)[:40]
    ref = np.asarray(regen(jnp.asarray(sd), jnp.asarray(idx), jnp.asarray(mue), jnp.asarray(std), K))
    popt = pctrl.optimizer
    got = regen_controls(torch.tensor(sd), torch.tensor(idx), torch.tensor(mue), torch.tensor(std),
                         popt.action_low, popt.action_high, K, TILE, fast=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=Q_ATOL)
    assert got.min() == -1.0 and got.max() == 1.0
    full = regen_controls(torch.tensor(sd), torch.arange(K), torch.tensor(mue), torch.tensor(std),
                          popt.action_low, popt.action_high, K, TILE, fast=False).numpy()
    np.testing.assert_array_equal(full[idx], got)  # an elite subset is a bit-exact subset


def test_regenerated_rows_through_k1_give_jax_kernel_costs(pair):
    """JAX's regenerated population through the port's K1 plain version
    gives the JAX K5's costs, and the port's K5 plain version is K1 over its
    own regenerated rows."""
    jctrl, pctrl, jparams, params = pair
    run, regen, jpack = jctrl.optimizer._build_fused_cem(interpret=True, tile_k=TILE)
    s0, mue, std, u_prev, sd = k5_inputs((99, 0))
    ref = np.asarray(run(jnp.asarray(s0), jnp.asarray(mue), jnp.asarray(std),
                         jpack(jparams, jnp.asarray(u_prev)), jnp.asarray(sd))).reshape(-1)
    Q = np.asarray(regen(jnp.asarray(sd), jnp.arange(K), jnp.asarray(mue), jnp.asarray(std), K))
    popt = pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    pvec = pack(params, torch.tensor(u_prev))
    s_tiled = torch.tensor(s0).expand(K, -1).contiguous()
    np.testing.assert_allclose(cost_rollout(model, s_tiled, torch.tensor(Q), pvec).numpy(), ref,
                               **K5_TOL)
    mine = regen_controls(torch.tensor(sd), torch.arange(K), torch.tensor(mue), torch.tensor(std),
                          popt.action_low, popt.action_high, K, TILE, fast=False)
    np.testing.assert_array_equal(
        fused_cem_costs_plain(model, torch.tensor(s0), torch.tensor(mue), torch.tensor(std), pvec,
                              torch.tensor(sd), popt.action_low, popt.action_high, K, TILE).numpy(),
        cost_rollout_plain(model, s_tiled, mine, pvec).numpy())


def use_fused(jctrl, pctrl, tile):
    """Both optimizers on their fully-fused paths at a CPU-sized tile: the
    JAX one's kernel in interpret mode (as tests/test_pallas_cem.py forces
    it), the port's K5 plain version."""
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    jopt._can_fully_fuse = lambda: True
    build = jopt._build_fused_cem
    jopt._build_fused_cem = lambda: build(interpret=True, tile_k=tile)
    jopt._build()
    popt.fused_tile_k = tile
    popt._build()
    assert popt._fused


def set_shared_state(jopt, popt, count=1):
    rng = np.random.default_rng(count)
    mue = rng.uniform(-0.4, 0.4, (1, H, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (1, H, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std), count=jnp.asarray(count, jnp.int32),
        u_prev=jnp.asarray(u_prev))
    popt.opt_state = CEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std),
                              count, torch.tensor(u_prev))


def jax_draws(jopt, iterations, fused):
    """The draws the JAX step takes: per outer iteration ``key, sub =
    split(key)``, then a randint seed (fused) or normals [K, H, U]."""
    key, draws = jopt.opt_state.key, []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        if fused:
            seed = int(jax.random.randint(sub, (1,), 0, 2**31 - 1, jnp.int32)[0])
            draws.append(torch.tensor([seed, 0], dtype=torch.int32))
        else:
            draws.append(torch.tensor(np.asarray(
                jax.random.normal(sub, (jopt.num_rollouts, jopt.mpc_horizon, 1), jnp.float32))))
    return draws


@pytest.mark.parametrize("fused,warmup", [(False, False), (True, False), (False, True)])
def test_one_cem_step_matches_jax(fused, warmup):
    """One step fed JAX's draws: the refit distribution (shifted), the
    applied control and the best elite.  With warmup the first step runs
    ``warmup_iterations`` (3) outer iterations."""
    jctrl, pctrl = make_pair(**cem_config(warmup=warmup, warmup_iterations=3,
                                          fully_fused=fused))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    if fused:
        use_fused(jctrl, pctrl, 64)
    count = 0 if warmup else 1
    set_shared_state(jopt, popt, count)
    iterations = 3 if warmup else 2
    draws = jax_draws(jopt, iterations, fused)
    assert len(popt.sample_draws(popt.opt_state)) == iterations
    jparams, params = both_params(jctrl)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **COST_TOL)
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(diag_j["u_nom"]), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    np.testing.assert_allclose(st.dist_mue.numpy(), np.asarray(st_j.dist_mue), **UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **UNOM_TOL)
    assert st.count == count + 1
    np.testing.assert_array_equal(st.u_prev.numpy(), u.numpy())


def test_update_refuses_a_wrong_number_of_draws():
    _, pctrl = make_pair(**cem_config(warmup=True, warmup_iterations=3))
    popt = pctrl.optimizer
    s = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="outer iterations"):
        popt.update(popt.opt_state, s, pctrl._assemble_params(), [torch.zeros(K, H, 1)] * 2)


def test_best_k_above_k_raises_at_construction():
    with pytest.raises(ValueError, match="cem_best_k"):
        make_pair(**cem_config(K=16, cem_best_k=32))


def test_fused_gate():
    """K5 only where the JAX gate would take it: the option on, logging off,
    and K a multiple of the tile (K % 2048 here); else the modular path."""
    _, pctrl = make_pair(**cem_config(K=4096, fully_fused=True))
    assert pctrl.optimizer._fused
    for cfg in (cem_config(K=K, fully_fused=True), cem_config(K=4096)):
        _, pctrl = make_pair(**cfg)
        assert not pctrl.optimizer._fused
    logged = MPCController("cartpole", LIMITS, {"target_position": 0.1},
                           config={"device": "cpu",
                                   "optimizer": "cem-tf", "controller_logging": True})
    logged.configure(optimizer_name="cem-tf", optimizer_config=cem_config(K=4096, fully_fused=True))
    assert not logged.optimizer._fused
    s = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    logged.step(s)
    out = logged.get_outputs()
    assert out["Q_logged"].shape == (1, 4096, H, 1)
    assert out["rollout_trajectories_logged"].shape == (1, 4096, H + 1, 4)


def test_cem_policy_warm_start_and_batched_steps():
    """The policy warm start centres the sampling mean on the plan (JAX
    cem.py:142-146); the modular (K1's session rows) and the fused (K6)
    batched steps build, and with warmup on raise."""
    _, pctrl = make_pair(**cem_config())
    opt = pctrl.optimizer
    for build in (opt._make_batched_cem_step, opt._make_batched_fused_cem_step):
        step, other = build(2)
        assert callable(step) and callable(other)
    opt.warmup = True
    for build in (opt._make_batched_cem_step, opt._make_batched_fused_cem_step):
        with pytest.raises(NotImplementedError, match="warmup=False"):
            build(2)
    opt.warmup = False
    plan = torch.full((opt.mpc_horizon, 1), 0.25)
    seeded = opt._apply_policy_guess(opt.opt_state, plan)
    assert torch.equal(seeded.dist_mue[0], plan) and seeded.stdev is opt.opt_state.stdev


def strong_cem(fused):
    """tests/test_pallas_cem.py make_strong_cem: the reference's full CEM
    budget (K=192, H=35, 3 outer iterations, 40 elites)."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "cem-tf", "controller_logging": False,
                                 "device": "cpu"})
    ctrl.configure(optimizer_name="cem-tf", optimizer_config={
        "seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 35, "num_rollouts": 192,
        "cem_outer_it": 3, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
        "cem_best_k": 40, "warmup": False, "warmup_iterations": 2, "fully_fused": fused})
    if fused:
        ctrl.optimizer.fused_tile_k = 64
        ctrl.optimizer._build()
    assert ctrl.optimizer._fused == fused
    return ctrl


@pytest.mark.parametrize("fused", [False, True])
def test_cem_closed_loop_holds_the_pole(fused):
    """60 ticks from CartpoleEnv(seed=5), as test_pallas_cem.py:109 runs
    the JAX package's (K5's plain version on the fused path)."""
    ctrl = strong_cem(fused)
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=5)
    s, _ = env.reset()
    for _ in range(60):
        s, *_ = env.step(ctrl.step(s[0]))
    assert abs(float(s[0, 2])) < 0.45, f"CEM (fused={fused}) lost the pole: {s[0]}"


def derivs_short_soa(xs, us, p):
    """csrc/plants.cuh derivs_short in float32, term for term: sin and cos
    of theta (the card's sincosf), the force, the reciprocals
    1 / (m_cart + m_pole) and 1 / (m_pole L) in place of four divisions,
    and the one division num / den."""
    pos_d, theta, theta_d = xs[1], xs[2], xs[3]
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    m_p, L = p["d_m_pole"], p["d_L"]
    inv_m, inv_mpl = 1.0 / (p["d_m_cart"] + m_p), 1.0 / (m_p * L)
    force = us[0] * p["d_u_max"]
    mpl = m_p * L
    temp = (force + mpl * (theta_d * theta_d) * sin_t - p["d_friction_cart"] * pos_d) * inv_m
    num = p["d_g"] * sin_t - cos_t * temp - p["d_friction_pole"] * theta_d * inv_mpl
    den = L * (4.0 / 3.0 - m_p * (cos_t * cos_t) * inv_m)
    theta_dd = num / den
    return (pos_d, temp - mpl * theta_dd * cos_t * inv_m, theta_d, theta_dd)


def short_step_fn(model, pvec):
    """``step(x [K,S], u [K,U]) -> x'``: csrc/short_step.cuh's control
    period (K5's step and K12's base step), the integrators' operation
    order over derivs_short."""
    p = model.unpack(pvec)
    one = make_soa_stepper(derivs_short_soa, model.integrator, model.dt, model.intermediate_steps)
    return lambda x, u: torch.stack(one(tuple(x.unbind(1)), tuple(u.unbind(1)), p), dim=1)


@pytest.mark.parametrize("integrator,substeps", [("rk4", 1), ("euler", 1), ("rk4", 2)])
def test_k5_short_step_stays_within_the_kernel_bound(pair, integrator, substeps,
                                                     record_property):
    """K5's new step in float32 (csrc/short_step.cuh: derivs_short, the
    stage cost before the step) over the controls K5 scores (regen_controls)
    at chip_smoke.py phase 27's inputs (s0, mue 0.2 N(0, 1) clipped, std
    0.5, seed2 [1234567, 0]) at K=512, H=50, tile 128, stays within
    KERNEL_TOL of fused_cem_costs_plain (rollout_core.cuh's derivs, five
    divisions); the distance is recorded."""
    import dataclasses
    from chip_smoke import KERNEL_TOL

    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    model = dataclasses.replace(model, integrator=integrator, intermediate_steps=substeps)
    Kc, Hc, tile = 512, 50, 128
    rng = np.random.default_rng(27)
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1])
    mue = torch.tensor(np.clip(0.2 * rng.standard_normal((Hc, 1)), -1.0, 1.0), dtype=torch.float32)
    std = torch.full((Hc, 1), 0.5)
    seed2 = torch.tensor([1234567, 0], dtype=torch.int32)
    pvec = pack(params, torch.tensor([0.1]))
    low, high = pctrl.optimizer.action_low, pctrl.optimizer.action_high
    ref = fused_cem_costs_plain(model, s0, mue, std, pvec, seed2, low, high, Kc, tile)
    Q = regen_controls(seed2, torch.arange(Kc), mue, std, low, high, Kc, tile, fast=False)
    got = plain_cost_loop(model, s0.expand(Kc, -1), Q, pvec, short_step_fn(model, pvec))
    err = (got - ref).abs()
    record_property("k5_short_step_distance", {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
        "equal_share": float((got == ref).double().mean())})
    torch.testing.assert_close(got, ref, **KERNEL_TOL)


def test_k5_short_step_at_a_long_horizon_stays_within_the_float64_bound(pair, record_property):
    """K5's step in float32 (short_step_fn) over the controls K5 scores at
    H=130, where K5 draws two full 64-control chunks and a partial one, at
    phase 27's inputs (K=512, tile 128), stays within chip_smoke.py's
    float64 bound (long_horizon_vs_float64: twice the float32 plain
    version's distance from float64), which rejects both chunk faults."""
    from chip_smoke import long_horizon_vs_float64

    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    Kc, Hc, tile = 512, 130, 128
    rng = np.random.default_rng(27)
    mue = torch.tensor(np.clip(0.2 * rng.standard_normal((Hc, 1)), -1.0, 1.0), dtype=torch.float32)
    seed2 = torch.tensor([1234567, 0], dtype=torch.int32)
    pvec = pack(params, torch.tensor([0.1]))
    low, high = pctrl.optimizer.action_low, pctrl.optimizer.action_high
    Q = regen_controls(seed2, torch.arange(Kc), mue, torch.full((Hc, 1), 0.5), low, high, Kc,
                       tile, fast=False)
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1]).expand(Kc, -1).contiguous()
    got = plain_cost_loop(model, s0, Q, pvec, short_step_fn(model, pvec))
    record_property("k5_long_horizon_vs_float64",
                    long_horizon_vs_float64(model, s0, Q, pvec, {"short_step": got}))


def k1_operands(pair, Kc=512, Hc=50):
    """chip_smoke.py phase 2's K1 operands at K=Kc, made with numpy: states
    0.05 N(0, 1), controls 0.3 N(0, 1) clipped to [-1, 1], u_prev 0.1."""
    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    rng = np.random.default_rng(2)
    s0 = torch.tensor(0.05 * rng.standard_normal((Kc, 4)), dtype=torch.float32)
    Q = torch.tensor(np.clip(0.3 * rng.standard_normal((Kc, Hc, 1)), -1.0, 1.0),
                     dtype=torch.float32)
    return model, s0, Q, pack(params, torch.tensor([0.1]))


@pytest.mark.parametrize("integrator,substeps", [("rk4", 1), ("euler", 1), ("rk4", 2)])
def test_k1_short_step_stays_within_the_kernel_bound(pair, integrator, substeps,
                                                     record_property):
    """K1's step in float32 (short_step_fn: csrc/short_step.cuh, K5's) over
    phase 2's controls at K=512, H=50 stays within KERNEL_TOL of K1's plain
    version (rollout_core.cuh's derivs, five divisions)."""
    import dataclasses
    from chip_smoke import KERNEL_TOL

    model, s0, Q, pvec = k1_operands(pair)
    model = dataclasses.replace(model, integrator=integrator, intermediate_steps=substeps)
    ref = cost_rollout_plain(model, s0, Q, pvec)
    got = plain_cost_loop(model, s0, Q, pvec, short_step_fn(model, pvec))
    err = (got - ref).abs()
    record_property("k1_short_step_distance", {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max())})
    torch.testing.assert_close(got, ref, **KERNEL_TOL)


@pytest.mark.parametrize("kind", ["controls_one_step_early", "next_rollout_row"])
def test_k1_bound_rejects_a_wrong_control_read(pair, kind, record_property):
    """K1's step in float32 over phase 2's controls read wrongly
    (chip_smoke.py k1_read_mutants: a prefetch off by one, rollout k+1's
    row) falls outside KERNEL_TOL of K1's plain version over the right
    ones, as phase 2 checks on the card."""
    from chip_smoke import KERNEL_TOL, k1_read_mutants

    model, s0, Q, pvec = k1_operands(pair)
    ref = cost_rollout_plain(model, s0, Q, pvec)
    wrong = plain_cost_loop(model, s0, k1_read_mutants(Q)[kind], pvec, short_step_fn(model, pvec))
    err = (wrong - ref).abs()
    record_property("k1_mutant_max_rel_err", float((err / ref.abs().clamp_min(1e-6)).max()))
    assert not torch.allclose(wrong, ref, **KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Hc", [50, 130])
def test_cuda_k5_matches_plain_version(pair, cuda_device, Hc):
    """K5 against its plain version on the same card tensors (K not a
    multiple of the block: the edge is masked), and the costs of the
    controls it regenerates through K1 against its own, at H=50 (one chunk
    of drawn controls) to KERNEL_TOL; at H=130 (two full chunks of 64 and
    a partial one), where float32 rounding outgrows KERNEL_TOL, both
    against float64 as chip_smoke.py phase 27 holds them."""
    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    dev = cuda_device
    Kc, tile = 1000 * 8, 400
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    mue = 0.2 * torch.randn(Hc, 1, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    std = torch.full((Hc, 1), 0.5, device=dev)
    pvec = pack(params, torch.tensor([0.1])).to(dev)
    seed2 = torch.tensor([2024, 3], dtype=torch.int32, device=dev)
    lim = torch.ones(1, device=dev)
    args = (model, s0, mue, std, pvec, seed2, -lim, lim, Kc, tile)
    got = fused_cem_costs(*args)
    Q = regen_controls(seed2, torch.arange(Kc, device=dev), mue, std, -lim, lim, Kc, tile,
                       fast=False)
    s_tiled = s0.expand(Kc, -1).contiguous()
    via_k1 = cost_rollout(model, s_tiled, Q, pvec)
    if Hc > 64:
        from chip_smoke import long_horizon_vs_float64

        long_horizon_vs_float64(model, s_tiled, Q, pvec, {"k5": got, "k1": via_k1})
        return
    torch.testing.assert_close(got, fused_cem_costs_plain(*args), rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got, via_k1, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("Hc", [50, 130])
def test_cuda_k5_equals_k1_over_its_regenerated_controls(pair, cuda_device, Hc):
    """K5 and K1 take one step (csrc/short_step.cuh), so K5's costs equal
    K1's over the controls that regen_controls draws again, bit for bit, at
    H=50 (one chunk of drawn controls) and H=130 (two full chunks and a
    partial one), as chip_smoke.py phase 27 requires."""
    _, pctrl, _, params = pair
    model, pack = ode.rollout_model(pctrl.optimizer)
    dev = cuda_device
    Kc, tile = 1000 * 8, 400
    s0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    mue = 0.2 * torch.randn(Hc, 1, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    std = torch.full((Hc, 1), 0.5, device=dev)
    pvec = pack(params, torch.tensor([0.1])).to(dev)
    seed2 = torch.tensor([2024, 3], dtype=torch.int32, device=dev)
    lim = torch.ones(1, device=dev)
    got = fused_cem_costs(model, s0, mue, std, pvec, seed2, -lim, lim, Kc, tile)
    Q = regen_controls(seed2, torch.arange(Kc, device=dev), mue, std, -lim, lim, Kc, tile,
                       fast=False)
    assert torch.equal(got, cost_rollout(model, s0.expand(Kc, -1).contiguous(), Q, pvec))
