"""The options every ported optimizer takes, against the JAX package: the
heuristic-policy warm start (``initial_guess_policy``), the
``calculate_optimal_trajectory`` diagnostics, ``remat``, the latency
tracker (``profile_latency``), the cost tester and
``CostFunctionWrapper.copy``.

The same inputs go to both packages, made from a seed with numpy; the
policy is written once in ``jnp`` and once in torch.  Counterparts of JAX
tests/test_policy_guess.py (over cartpole), tests/test_fused_rollout.py:87
and tests/test_aux_subsystems.py:62, :88.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.costs.tester import CostFunctionTester as JaxTester
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.tester import CostFunctionTester
from control_toolkit_tpu_torch.costs.wrapper import CostFunctionWrapper
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from control_toolkit_tpu_torch.utils.profiling import LatencyTracker, torch_trace

from test_torch_cem_gmm import gmm_config
from test_torch_cem_grad import bharadhwaj_config, naive_config
from test_torch_cma_es import cma_config
from test_torch_mppi import (
    CPU, LIMITS, jax_next_draw, jax_params_numpy, optimizer_config, port_noise,
    set_shared_state,
)
from test_torch_rpgd import gradient_config, jax_rpgd_draw, rpgd_config, set_rpgd_state
from test_torch_zoo import icem_config, zoo_config

# The plan: H closed-loop rk4 steps of the policy through single_step, in
# float32 on both sides.
PLAN_TOL = dict(rtol=1e-5, atol=1e-6)
# The optimal trajectory and the summed stage cost: one H-step rollout of
# plans that agree to the MPPI (rtol 1e-4, atol 1e-5) and RPGD (Q_TOL)
# tolerances.
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
S0 = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
ATTRS = {"target_position": 0.3}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_policy(x, params):
    """A linear cartpole policy that reads the target from the attributes
    and saturates at the action bounds for some states."""
    return jnp.asarray([4.0 * x[2] + x[3] - 0.8 * (x[0] - params["attrs"]["target_position"])
                        + 0.2 * x[1]])


def torch_policy(x, params):
    return torch.stack([4.0 * x[2] + x[3] - 0.8 * (x[0] - params["attrs"]["target_position"])
                        + 0.2 * x[1]])


SEEDED = {
    "mppi": optimizer_config(128, 16),
    "cem-tf": zoo_config(cem_outer_it=2, cem_best_k=16),
    "icem-tf": icem_config(),
    "cem-gmm-tf": gmm_config(),
    "cma-es-tf": cma_config(),
    "rpgd-tf": rpgd_config(),
    "gradient-tf": gradient_config(),
}
IGNORED = {
    "cem-naive-grad-tf": naive_config(),
    "cem-grad-bharadhwaj-tf": bharadhwaj_config(),
    "random-action-tf": zoo_config(),
}


def make_pair(name, cfg, policy=True, controller=None):
    """The JAX and the port controller on one optimizer config, each with
    its package's policy (``policy``) or none."""
    controller = dict(controller or {}, controller_logging=False, optimizer=name)
    jctrl = JaxMPC("cartpole", LIMITS, dict(ATTRS), config=dict(controller))
    jctrl.configure(optimizer_name=name, optimizer_config=dict(
        cfg, **({"initial_guess_policy": jax_policy} if policy else {})))
    pctrl = MPCController("cartpole", LIMITS, dict(ATTRS), config=dict(controller, device="cpu"))
    pctrl.configure(optimizer_name=name, optimizer_config=dict(
        cfg, **({"initial_guess_policy": torch_policy} if policy else {})))
    return jctrl, pctrl


def both_params(jctrl):
    tree = jctrl._assemble_params()
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(jax_params_numpy(jctrl), CPU))


def fields(state, prefix=""):
    """A state's array leaves by dotted name (Adam moments included); the
    PRNG key or generator, the host counters and the scalars (CMA-ES's
    sigma, which no hook touches) left out."""
    out = {}
    for name, v in state._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(fields(v, f"{prefix}{name}."))
        elif isinstance(v, (torch.Tensor, jax.Array)) and name != "key" and v.ndim:
            out[prefix + name] = np.asarray(v)
    return out


# ---- the policy warm start -------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SEEDED))
def test_policy_plan_and_seeded_state_match_jax(name):
    """The closed-loop policy plan equals JAX's (PLAN_TOL: rtol 1e-5, atol
    1e-6), and the hook writes it where JAX's does: every entry that JAX's
    _apply_policy_guess changed holds JAX's value in the port's seeded
    state (the plan, zeroed moments, age 0), every other entry is the
    port's own, unchanged."""
    jctrl, pctrl = make_pair(name, SEEDED[name])
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert jopt._policy_seed_pending and popt._policy_seed_pending
    jparams, pparams = both_params(jctrl)
    jplan = np.asarray(jopt._policy_plan()(jnp.asarray(S0)[None], jparams))
    pplan = popt._policy_plan(torch.tensor(S0)[None], pparams)
    assert pplan.shape == (popt.mpc_horizon, 1)
    np.testing.assert_allclose(pplan.numpy(), jplan, **PLAN_TOL)
    assert np.abs(jplan).max() == 1.0  # the clip to the action box took part

    jbefore, pbefore = fields(jopt.opt_state), fields(popt.opt_state)
    jseeded = fields(jopt._apply_policy_guess(jopt.opt_state, jnp.asarray(jplan)))
    pseeded = fields(popt._apply_policy_guess(popt.opt_state, torch.tensor(jplan)))
    touched = [k for k in jseeded if not np.array_equal(jseeded[k], jbefore[k])]
    assert touched
    for k, v in pseeded.items():
        changed = ~np.equal(jseeded[k], jbefore[k]) if k in touched else np.zeros(v.shape, bool)
        np.testing.assert_array_equal(v[changed], jseeded[k][changed], err_msg=k)
        np.testing.assert_array_equal(v[~changed], pbefore[k][~changed], err_msg=k)


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_policy_seed_is_consumed_and_rearmed(name, monkeypatch):
    """The next step consumes the seed and leaves another state than an
    unseeded optimizer's with the same seed; optimizer_reset re-arms it,
    and so does the NaN guard (a non-finite control resets the
    optimizer)."""
    _, pctrl = make_pair(name, SEEDED[name])
    _, bare = make_pair(name, SEEDED[name], policy=False)
    popt = pctrl.optimizer
    assert not bare.optimizer._policy_seed_pending
    u_pol = pctrl.step(S0)
    bare.step(S0)
    assert not popt._policy_seed_pending
    assert np.all(np.isfinite(u_pol)) and np.all(np.abs(u_pol) <= 1.0)
    seeded, unseeded = fields(popt.opt_state), fields(bare.optimizer.opt_state)
    assert any(not np.allclose(seeded[k], unseeded[k]) for k in seeded)
    popt.optimizer_reset()
    assert popt._policy_seed_pending
    pctrl.step(S0)
    assert not popt._policy_seed_pending

    step_fn = popt._step_fn

    def diverged(state, s, params):
        u, state, diag = step_fn(state, s, params)
        return torch.full_like(u, float("nan")), state, diag

    monkeypatch.setattr(popt, "_step_fn", diverged)
    np.testing.assert_array_equal(pctrl.step(S0), np.zeros(1, np.float32))
    assert popt._policy_seed_pending


@pytest.mark.parametrize("name", sorted(IGNORED))
def test_policy_is_accepted_and_ignored_where_jax_has_no_hook(name):
    """cem-naive-grad, cem-grad-bharadhwaj and random-action have no
    _apply_policy_guess in either package: the policy is accepted, never
    armed, and the steps equal an unseeded optimizer's."""
    jctrl, pctrl = make_pair(name, IGNORED[name])
    _, bare = make_pair(name, IGNORED[name], policy=False)
    for opt in (jctrl.optimizer, pctrl.optimizer):
        assert not hasattr(opt, "_apply_policy_guess") and not opt._policy_seed_pending
    for _ in range(2):
        np.testing.assert_array_equal(pctrl.step(S0), bare.step(S0))
    pctrl.optimizer.optimizer_reset()
    assert not pctrl.optimizer._policy_seed_pending


def test_policy_needs_single_step():
    """As in JAX: a predictor without single_step raises ValueError."""
    _, pctrl = make_pair("mppi", SEEDED["mppi"])

    class NoStep:
        single_step = None

    pctrl.optimizer.predictor = NoStep()
    with pytest.raises(ValueError, match="single_step"):
        pctrl.optimizer._policy_plan(torch.tensor(S0)[None], pctrl._assemble_params())


# ---- calculate_optimal_trajectory ---------------------------------------------------------------
@pytest.mark.parametrize("name,extra,semi_fused", [
    ("mppi", {}, True),
    ("mppi", {"semi_fused": False}, False),
    ("mppi-optimize-tf", {"optim_steps": 3, "mppi_LR": 0.05}, True),
])
def test_mppi_optimal_trajectory_matches_jax(name, extra, semi_fused):
    """MPPI's optimal_trajectory (the nominal plan's replay from s[:1]) on
    the semi-fused and modular paths, fed JAX's draws, against JAX's
    (TRAJ_TOL), and kept on the host by step()."""
    cfg = optimizer_config(128, 16, **extra)
    jctrl, pctrl = make_pair(name, cfg, policy=False,
                             controller={"calculate_optimal_trajectory": True})
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused() == semi_fused and not popt._can_fully_fuse()
    set_shared_state(jopt, popt)
    delta = jax_next_draw(jopt)
    jctrl.step(S0)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    _, _, diag = popt.update(popt.opt_state, torch.tensor(S0)[None], params,
                             port_noise(popt, delta))
    assert diag["optimal_trajectory"].shape == (1, 17, 4)
    np.testing.assert_allclose(diag["optimal_trajectory"].numpy(), jopt.optimal_trajectory,
                               **TRAJ_TOL)
    pctrl.step(S0)
    assert isinstance(popt.optimal_trajectory, np.ndarray)
    assert popt.optimal_trajectory.shape == (1, 17, 4)


def test_mppi_var_optimal_trajectory_takes_the_modular_path():
    """JAX mppi_var.py:243: the option closes the semi-fused gate; the
    modular step's diagnostics carry the trajectory, JAX's from the same
    draws (TRAJ_TOL)."""
    from test_torch_mppi_var import var_config

    cfg = var_config(128, 16)
    jctrl, pctrl = make_pair("mppi-var-tf", cfg, policy=False,
                             controller={"calculate_optimal_trajectory": True})
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not popt._uses_semi_fused() and popt._noise_shape[0] == 128
    _, pbare = make_pair("mppi-var-tf", cfg, policy=False)
    assert pbare.optimizer._uses_semi_fused()
    _, sample_key = jax.random.split(jopt.opt_state.key)
    eps = np.asarray(jax.random.normal(sample_key, popt._noise_shape, dtype=jnp.float32))
    jctrl.step(S0)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    _, _, diag = popt.update(popt.opt_state, torch.tensor(S0)[None], params, torch.tensor(eps))
    np.testing.assert_allclose(diag["optimal_trajectory"].numpy(), jopt.optimal_trajectory,
                               **TRAJ_TOL)


def test_rpgd_optimal_trajectory_and_summed_stage_cost_match_jax():
    """RPGD's optimal_trajectory and summed_stage_cost (JAX rpgd.py:435-440)
    on a resample tick from a shared population, fed JAX's draw, against
    JAX's (TRAJ_TOL)."""
    jctrl, pctrl = make_pair("rpgd-tf", rpgd_config(), policy=False,
                             controller={"calculate_optimal_trajectory": True})
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_rpgd_state(jopt, popt, count=0)
    draw = jax_rpgd_draw(jopt)
    jctrl.step(S0)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    _, _, diag = popt.update(popt.opt_state, torch.tensor(S0)[None], params, torch.tensor(draw))
    np.testing.assert_allclose(diag["optimal_trajectory"].numpy(), jopt.optimal_trajectory,
                               **TRAJ_TOL)
    np.testing.assert_allclose(diag["summed_stage_cost"].numpy(), jopt.summed_stage_cost,
                               **TRAJ_TOL)
    pctrl.step(S0)
    assert popt.optimal_trajectory.shape == (1, 16, 4) and popt.summed_stage_cost.shape == (1,)


def test_gradient_accepts_the_key_and_emits_nothing():
    """gradient-tf takes calculate_optimal_trajectory and, as JAX's,
    produces no trajectory."""
    jctrl, pctrl = make_pair("gradient-tf", gradient_config(), policy=False,
                             controller={"calculate_optimal_trajectory": True})
    for ctrl in (jctrl, pctrl):
        assert ctrl.optimizer.calculate_optimal_trajectory
        assert np.all(np.isfinite(ctrl.step(S0)))
        assert ctrl.optimizer.optimal_trajectory is None


def test_summed_stage_cost_matches_jax():
    """CostFunction.get_summed_stage_cost (JAX costs/base.py:208), through
    the wrapper, against JAX's on seeded states and controls (rtol 1e-5,
    atol 1e-4: float32 sums of the stage costs)."""
    jctrl, pctrl = make_pair("mppi", SEEDED["mppi"], policy=False)
    rng = np.random.default_rng(3)
    traj = (0.3 * rng.standard_normal((5, 9, 4))).astype(np.float32)
    Q = rng.uniform(-1, 1, (5, 8, 1)).astype(np.float32)
    up = np.array([0.2], np.float32)
    jparams, pparams = both_params(jctrl)
    cp = {"cost": pparams["cost"], "attrs": pparams["attrs"]}
    want = jctrl.cost_function.get_summed_stage_cost(
        jnp.asarray(traj), jnp.asarray(Q), jnp.asarray(up),
        {"cost": jparams["cost"], "attrs": jparams["attrs"]})
    got = pctrl.cost_function.get_summed_stage_cost(torch.tensor(traj), torch.tensor(Q),
                                                    torch.tensor(up), cp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# ---- remat --------------------------------------------------------------------------------------
def test_remat_gradient_is_bit_equal_and_saves_fewer_tensors():
    """On the autograd path (force_scan: the fused loop), dQ with remat
    equals dQ without bit for bit, and the backward keeps fewer saved
    tensors (a counterpart of JAX tests/test_fused_rollout.py:87)."""
    _, plain = make_pair("rpgd-tf", rpgd_config(force_scan=True), policy=False)
    _, remat = make_pair("rpgd-tf", rpgd_config(force_scan=True, remat=True), policy=False)
    assert remat.optimizer.remat and not plain.optimizer.remat
    opt = plain.optimizer
    Q = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (opt.num_rollouts,
                                                              opt.mpc_horizon, 1)),
                     dtype=torch.float32)
    s_tiled = torch.tensor(S0)[None].expand(opt.num_rollouts, -1).contiguous()
    up, params = torch.tensor([0.2]), plain._assemble_params()

    def grad_and_saved(ctrl):
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t

        cost_fn = ctrl.optimizer._make_cost_only(differentiable=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            Qv = Q.clone().requires_grad_(True)
            cost = cost_fn(s_tiled, Qv, up, params).sum()
        (dQ,) = torch.autograd.grad(cost, Qv)
        return dQ, sum(saved)

    dQ, n_plain = grad_and_saved(plain)
    dQ_remat, n_remat = grad_and_saved(remat)
    assert torch.equal(dQ, dQ_remat)
    assert n_remat < n_plain
    # The optimizer's own gradient path takes it too.
    g = remat.optimizer._make_grad_and_cost_only()[0]
    assert torch.equal(g(Q, s_tiled, up, params), dQ)


# ---- the latency tracker, the cost tester and copy() ---------------------------------------------
def test_latency_tracker_percentiles():
    """JAX tests/test_aux_subsystems.py:62 on the port's tracker."""
    t = LatencyTracker()
    for v in [0.001, 0.002, 0.003, 0.010]:
        t.record(v)
    p = t.percentiles()
    assert 1.0 <= p["p50_ms"] <= 3.0
    assert p["max_ms"] == pytest.approx(10.0)
    assert "p99" in t.report()
    t.reset()
    assert len(t) == 0 and t.report() == "no latency samples recorded"


def test_profile_latency_times_each_step(caplog):
    """profile_latency (JAX mpc.py:127-130, :250-254): every optimizer.step
    is timed, and controller_report logs the percentiles."""
    _, pctrl = make_pair("mppi", SEEDED["mppi"], policy=False,
                         controller={"profile_latency": True})
    _, off = make_pair("mppi", SEEDED["mppi"], policy=False)
    assert off.latency is None
    for _ in range(3):
        pctrl.step(S0)
    assert len(pctrl.latency) == 3 and pctrl.latency.percentiles()["p50_ms"] > 0.0
    with caplog.at_level(logging.INFO):
        pctrl.controller_report()
    assert "controller.step latency over 3 steps" in caplog.text


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cost_tester_collects_components_as_jax():
    """JAX tests/test_aux_subsystems.py:88 on the port's tester: the same
    components of the cartpole cost, each buffered by its first entry and
    equal to JAX's (rtol 1e-6); plot() empties the buffers."""
    from control_toolkit_tpu.costs.cartpole import CartpoleQuadraticCost as JaxCost
    from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost

    states = np.random.default_rng(0).normal(size=(2, 5, 4)).astype(np.float32)
    inputs = np.random.default_rng(1).normal(size=(2, 5, 1)).astype(np.float32)
    jt, pt = JaxTester(JaxCost()), CostFunctionTester(CartpoleQuadraticCost())
    for _ in range(4):
        jt.collect_costs(states, inputs)
        pt.collect_costs(states, inputs)
    want, got = jt.to_arrays(), pt.to_arrays()
    assert set(got) == set(want) == {"dd", "ep", "ekp", "cc"}
    for k in want:
        assert got[k].shape == (4,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert pt.plot(show=False) is not None and pt.buffers == {}
    with pytest.raises(TypeError, match="cost_components"):
        from control_toolkit_tpu_torch.costs.acrobot import AcrobotSwingupCost
        CostFunctionTester(AcrobotSwingupCost())


@pytest.mark.parametrize("env,spec", [("pointmass", "default"), ("pointmass", "obstacles"),
                                      ("quadrotor2d", "default"), ("quadrotor3d", "default"),
                                      ("car", "default"), ("car", "obstacles"),
                                      ("arm2", "default")])
def test_cost_tester_over_the_plants_matches_jax(env, spec):
    """The tester over each plant cost with components, through its
    wrapper, against JAX's tester on the same states and inputs (rtol
    1e-5, atol 1e-6)."""
    from control_toolkit_tpu.costs.wrapper import CostFunctionWrapper as JaxWrapper

    from test_torch_plants import DIMS

    S, U = DIMS[env]
    rng = np.random.default_rng(7)
    states = rng.normal(size=(3, 6, S)).astype(np.float32)
    inputs = rng.uniform(0.0, 1.0, (3, 6, U)).astype(np.float32)
    jw, pw = JaxWrapper(), CostFunctionWrapper()
    jw.configure(3, 6, environment_name=env, cost_function_specification=spec,
                 watch_config=False)
    pw.configure(3, 6, environment_name=env, cost_function_specification=spec,
                 watch_config=False)
    jt, pt = JaxTester(jw), CostFunctionTester(pw)
    for _ in range(2):
        jt.collect_costs(states, inputs)
        pt.collect_costs(states, inputs)
    want, got = jt.to_arrays(), pt.to_arrays()
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_copy_keeps_the_live_weights():
    """copy() (JAX wrapper.py:116-134) gives a configured wrapper of the
    same name whose cost holds the source's live weights, an override and
    a hot-reloaded value included, not the YAML file's; an unconfigured
    source gives an unconfigured copy."""
    src = CostFunctionWrapper()
    src.configure(8, 10, environment_name="cartpole",
                  cost_config={"dd_weight": 7.0, "ep_weight": 123.0})
    src.cost_function.config["ekp_weight"] = 3.5  # as a hot reload writes it
    dup = src.copy()
    assert dup is not src and dup.cost_function is not src.cost_function
    assert (dup.cost_function_name, dup.environment_name) == ("default", "cartpole")
    assert (dup.cost_function.batch_size, dup.cost_function.horizon) == (8, 10)
    assert dup.cost_function.config == src.cost_function.config
    assert dup.current_params()["cost"]["ekp_weight"] == 3.5
    assert dup.current_params()["cost"]["dd_weight"] == 7.0
    assert dup._updater is None  # nothing watched
    src.cost_function.config["dd_weight"] = 1.0
    assert dup.cost_function.config["dd_weight"] == 7.0  # a copy, not a view
    empty = CostFunctionWrapper().copy()
    assert empty.cost_function is None and empty.cost_function_name is None
