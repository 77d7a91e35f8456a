"""The port's iLQR (``optimizers/ilqr.py``) against the JAX package's
``ILQROptimizer``, pass by pass, then the step's bookkeeping, a whole
step, the refusals and the JAX package's behaviour tests.

Each pass is held alone, fed the same inputs: the JAX pass is reached
through the closures of the JAX optimizer's own ``_make_step_fn`` (its
``_debug_backward_pair`` and ``_debug_rollout``, and the free variables of
its ``step_fn``), run under ``jax.jit``, and nothing of the JAX package is
changed.  Cart-pole at H = HP over rk4, unconstrained and with a state box
(|velocity| <= 0.2) and a terminal set (lambda drawn in [0, 2], mu = 10).  Tolerances, each
with its reason:

* LIN_TOL, the quadratic model: float32 rounding of two AD orders (JAX
  forward mode for the Jacobian, the port reverse mode), each entry a
  short sum;
* GAIN_TOL, the sequential gains against JAX's sequential gains from the
  same model: a Riccati recursion of HP steps in float32 over a model
  whose Quu spans 1e-6 (at reg 1e-6) to 1e2, relative error growing with
  the condition number;
* PAR_TOL, the parallel gains against JAX's parallel gains and against
  the sequential ones: the JAX test's own (``tests/test_ilqr.py:347-350``,
  rtol 2e-3, atol 2e-5 on k and 2e-4 on K; the constrained case rtol 2e-3,
  atol 2e-4 and 2e-3, ``:377-380``): the scan trees differ (JAX's
  odd-even ``associative_scan``, the port's Hillis-Steele levels), so the
  products are summed in other orders;
* FWD_TOL, the line search: HP rk4 steps from the same gains, float32;
* STEP_TOL, whole steps of a few iterations: the passes' rounding carried
  through accepted line searches, u and the plan to 2e-4 where the
  problem is well conditioned (the JAX package's own comment, ``:323-325``,
  says full solves agree only loosely across float orderings).

The behaviour tests are the JAX package's (``tests/test_ilqr.py`` and
``tests/test_optimizer_zoo.py:185``), each at its configuration and
threshold; the loops run whole (each ~40-60 s of one CPU thread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.costs.base import CostFunction as JaxCostFunction
from control_toolkit_tpu.models import dynamics as jdyn
from control_toolkit_tpu.models.predictors import ODEPredictor as JaxODEPredictor
from control_toolkit_tpu.optimizers.ilqr import ILQROptimizer as JaxILQR
from control_toolkit_tpu.optimizers.ilqr import ILQRState as JaxILQRState
from control_toolkit_tpu.utils import registry as jregistry
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.base import CostFunction
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.models import dynamics as pdyn
from control_toolkit_tpu_torch.models.predictors import ODEPredictor
from control_toolkit_tpu_torch.optimizers.ilqr import ILQROptimizer, ILQRState, Quadratic
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.convert import params_from_numpy

CPU = torch.device("cpu")
LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
HP = 16  # the per-pass horizon
LIN_TOL = dict(rtol=1e-4, atol=1e-5)
GAIN_TOL = dict(rtol=1e-3, atol=1e-5)
PAR_TOL = {"k": dict(rtol=2e-3, atol=2e-5), "K": dict(rtol=2e-3, atol=2e-4)}
PAR_TOL_CON = {"k": dict(rtol=2e-3, atol=2e-4), "K": dict(rtol=2e-3, atol=2e-3)}
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
CONSTRAINED = {"state_max": ["inf", 0.2, "inf", "inf"], "terminal_set_width": 0.1,
               "idx_terminal_set": [0], "terminal_set_center": ["target_position"],
               "al_iterations": 3}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ilqr_config(H=HP, **extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 1,
           "max_iterations": 5, "tol": 1e-7, "regularization_init": 1.0,
           "regularization_max": 1e8, "line_search_steps": 8}
    cfg.update(extra)
    return cfg


def make_pair(cfg, env="cartpole", limits=LIMITS, attrs=None, spec="ODE", logging=True):
    """The JAX and the port ``mpc`` controller over ``spec`` with one ilqr
    config."""
    attrs = {"target_position": 0.3} if attrs is None else attrs
    jctrl = JaxMPC(env, limits, dict(attrs),
                   config={"optimizer": "ilqr", "controller_logging": logging})
    jctrl.configure(optimizer_name="ilqr", predictor_specification=spec,
                    optimizer_config=dict(cfg))
    pctrl = MPCController(env, limits, dict(attrs),
                          config={"device": "cpu", "optimizer": "ilqr",
                                  "controller_logging": logging})
    pctrl.configure(optimizer_name="ilqr", predictor_specification=spec,
                    optimizer_config=dict(cfg))
    return jctrl, pctrl


def both_params(jctrl):
    tree = jax.tree_util.tree_map(np.asarray, jctrl._assemble_params())
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(tree, CPU))


def closure(fn, name):
    """The free variable ``name`` of the function ``fn``."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


class JaxPasses:
    """The JAX step's passes, from the closures of a fresh ``_make_step_fn``."""

    def __init__(self, jopt):
        self.step_fn = jopt._make_step_fn()
        self.seq, self.par = jopt._debug_backward_pair
        self.rollout = jopt._debug_rollout
        solve = closure(self.step_fn, "solve")
        self.inner_iter = closure(solve, "inner_iter")
        self.linearize = closure(self.seq, "linearize")
        self.forward_pass = closure(self.inner_iter, "forward_pass")
        self.box_violation = closure(solve, "box_violation")
        self.term_violation = closure(solve, "term_violation")
        self.total_cost_al = closure(solve, "total_cost_al_from")
        self.alphas = jopt.alphas


REGS = (1e-6, 1.0, 100.0)
# The inner iteration's cases: (the incumbent cost's offset, reg) -- one
# that a candidate improves, one no candidate beats (reg x 10) and one at
# reg_max's cap.
INNER_CASES = {"improves": (0.0, 1.0), "rejects": (-1e4, 1.0), "capped": (-1e4, 0.5e8)}


def jax_references(jp, pb, jparams) -> dict:
    """Every JAX pass on the problem ``pb``, in one jitted program (the
    backward passes at each of REGS, the line search from the sequential
    gains at reg 1, the inner iteration in each of INNER_CASES, the
    multiplier update)."""
    zs, us, lam, lam_t = (j(pb[k]) for k in ("zs", "us", "lam", "lam_t"))
    mu, center = jnp.float32(pb["mu"]), j(pb["center"])

    @jax.jit
    def run(params):
        out = {"lin": jp.linearize(zs, us, lam, lam_t, mu, center, params)}
        for name, bw in (("seq", jp.seq), ("par", jp.par)):
            out[name] = jax.vmap(lambda r: bw(zs, us, lam, lam_t, mu, center, r, params))(
                jnp.asarray(REGS, jnp.float32))
        ks, Ks = out["seq"][0][1], out["seq"][1][1]
        out["fwd"] = jax.vmap(lambda a: jp.forward_pass(zs[0], zs, us, ks, Ks, a, lam, lam_t,
                                                        mu, center, params))(jp.alphas)
        cost0 = jp.total_cost_al(zs, us, lam, lam_t, mu, center, params)
        offsets, regs = (jnp.asarray(v, jnp.float32) for v in zip(*INNER_CASES.values()))
        out["cost0"] = cost0
        out["inner"] = jax.vmap(lambda c, r: jp.inner_iter((us, zs, cost0 + c, r), None, zs[0],
                                                           lam, lam_t, mu, center, params)[0])(
            offsets, regs)
        if lam.shape[1]:
            out["lam"] = jnp.maximum(0.0, lam + mu * jax.vmap(jp.box_violation)(zs))
            out["lam_t"] = jnp.maximum(0.0, lam_t + mu * jp.term_violation(zs[-1], center))
        return out

    return jax.tree_util.tree_map(np.asarray, run(jparams))


def t(a):
    return torch.tensor(np.asarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def close(got, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), err_msg=what, **tol)


_PAIRS = {}


def pass_pair(constrained: bool):
    """Module-cached: the port controller and params, one problem (z0, a
    seeded plan, its rollout, multipliers, mu, the center) and JAX's
    passes on it."""
    if constrained not in _PAIRS:
        cfg = ilqr_config(**(CONSTRAINED if constrained else {}))
        jctrl, pctrl = make_pair(cfg)
        jparams, pparams = both_params(jctrl)
        jp = JaxPasses(jctrl.optimizer)
        rng = np.random.default_rng(1 if constrained else 0)
        z0 = np.array([0.5, 0.1, 0.3, -0.2, 0.0] if constrained
                      else [0.15, -0.3, 0.35, 0.2, 0.0], np.float32)
        us = rng.uniform(-0.8, 0.8, (HP, 1)).astype(np.float32)
        zs = np.asarray(jp.rollout(j(z0), j(us), jparams))
        n_box, n_term = (2, 2) if constrained else (0, 0)
        lam = rng.uniform(0.0, 2.0, (HP + 1, n_box)).astype(np.float32)
        lam_t = rng.uniform(0.0, 2.0, (n_term,)).astype(np.float32)
        mu = np.float32(10.0 if constrained else 0.0)
        center = np.array([0.3] if constrained else [], np.float32)
        pb = dict(z0=z0, us=us, zs=zs, lam=lam, lam_t=lam_t, mu=mu, center=center)
        _PAIRS[constrained] = (pctrl, pparams, pb, jax_references(jp, pb, jparams))
    return _PAIRS[constrained]


def port_args(pb, pparams):
    return (t(pb["zs"])[None], t(pb["us"])[None], t(pb["lam"])[None], t(pb["lam_t"])[None],
            float(pb["mu"]), t(pb["center"]), pparams)


def quadratic_from_jax(ref) -> Quadratic:
    """JAX's linearization as the port's Quadratic (leading start dim 1)."""
    return Quadratic(*(t(a)[None] for a in ref))


# ---- the registry and the refusals ----------------------------------------------------------
def test_three_names_resolve_to_one_class_and_four_controllers_remain():
    registry._load_builtins()
    jregistry._load_builtins()
    classes = {registry.import_optimizer_by_name(n) for n in ("ilqr", "nlp-ilqr", "nlp-forces")}
    assert classes == {ILQROptimizer} and ILQROptimizer.registered_name == "ilqr"
    assert registry.import_controller_by_name("nlp-forces") is MPCController
    # The JAX package's own names (a test may load an ASF plugin's into its
    # registry: the template's "barebone" controller).
    missing = {kind: sorted({n for n in getattr(jregistry, kind).names()
                             if getattr(jregistry, kind).get(n).__module__.split(".")[0]
                             == "control_toolkit_tpu"}
                            - set(getattr(registry, kind).names()))
               for kind in ("controllers", "optimizers")}
    assert missing == {"controllers": ["c", "embedded", "neural-imitator", "remote"],
                       "optimizers": []}


def test_riccati_mode_validation():
    with pytest.raises(ValueError, match="riccati"):
        make_pair(ilqr_config(riccati="banana"))


@pytest.mark.parametrize("spec", ["neural:GRU-5IN-8H1-4OUT", "ensemble:mlp-16:2:nowhere:ts1"])
def test_predictor_without_single_step_refused_at_configure(spec):
    """A recurrent or TS-1 predictor has no single_step: ValueError at
    configure naming it (the JAX class fails at its first step)."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "ilqr",
                                 "controller_logging": False})
    with pytest.raises(ValueError, match=r"(NeuralPredictor|EnsemblePredictor).*single_step"):
        ctrl.configure(optimizer_name="ilqr", predictor_specification=spec,
                       optimizer_config=ilqr_config())


def test_fleet_refused_naming_the_vmapped_step():
    """An iLQR fleet takes the JAX package's vmapped per-slot step, the
    port's per-slot step (the step's own host read of ``solver_ok`` kept):
    each active slot equals its single-session controller bit for bit."""
    from test_torch_fleet_per_slot import assert_slots_equal_single

    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"device": "cpu", "optimizer": "ilqr",
                                        "controller_logging": False})
    ctrl.configure(optimizer_name="ilqr", optimizer_config=ilqr_config(max_iterations=2),
                   num_slots=2)
    assert ctrl._per_slot
    assert_slots_equal_single(ctrl)


# ---- each pass alone -------------------------------------------------------------------------
@pytest.mark.parametrize("constrained", [False, True])
def test_linearization_matches_jax(constrained):
    pctrl, pparams, pb, ref = pass_pair(constrained)
    got = pctrl.optimizer.linearize(*port_args(pb, pparams))
    names = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "Vx", "Vxx")
    for name, g, r in zip(names, got, ref["lin"]):
        assert g.dtype == torch.float32
        close(g[0], r, LIN_TOL, name)
    if constrained:
        # The penalty's Hessian is nonzero where the box binds (|z_1| > 0.2 -
        # lam / mu at some steps of this plan).
        assert np.abs(ref["lin"][4][:, 1, 1]).max() > 1.0


@pytest.mark.parametrize("reg", range(len(REGS)), ids=[str(r) for r in REGS])
@pytest.mark.parametrize("constrained", [False, True])
def test_backward_passes_match_jax(constrained, reg):
    """Sequential and parallel gains from JAX's own linearization, each
    against JAX's pass of that structure, and the port's two structures
    against each other (the DP of one modified LQR)."""
    pctrl, pparams, pb, ref = pass_pair(constrained)
    opt = pctrl.optimizer
    q = quadratic_from_jax(ref["lin"])
    regs = torch.tensor([REGS[reg]], dtype=torch.float32)
    ks1, Ks1 = opt.backward_sequential(q, regs)
    ks2, Ks2 = opt.backward_parallel(q, regs)
    close(ks1[0], ref["seq"][0][reg], GAIN_TOL, "k sequential")
    close(Ks1[0], ref["seq"][1][reg], GAIN_TOL, "K sequential")
    tol = PAR_TOL_CON if constrained else PAR_TOL
    close(ks2[0], ref["par"][0][reg], tol["k"], "k parallel vs JAX parallel")
    close(Ks2[0], ref["par"][1][reg], tol["K"], "K parallel vs JAX parallel")
    close(ks2, ks1, tol["k"], "k parallel vs sequential")
    close(Ks2, Ks1, tol["K"], "K parallel vs sequential")


def test_singular_quu_gives_nonfinite_gains_not_an_exception():
    """Quu = 0 (no control cost, no control authority, reg 0): both passes
    return non-finite gains, as jnp.linalg.inv does, for the replay."""
    pctrl, pparams, pb, ref = pass_pair(False)
    q = quadratic_from_jax(ref["lin"])
    q = q._replace(B=torch.zeros_like(q.B), luu=torch.zeros_like(q.luu),
                   lux=torch.zeros_like(q.lux))
    for backward in (pctrl.optimizer.backward_sequential, pctrl.optimizer.backward_parallel):
        ks, Ks = backward(q, torch.zeros(1))
        assert not bool(torch.isfinite(ks).all())
        assert not bool(torch.isfinite(Ks).all())


@pytest.mark.parametrize("constrained", [False, True])
def test_forward_pass_matches_jax(constrained):
    """Every step size's cost and trajectory from JAX's gains (reg 1)."""
    pctrl, pparams, pb, ref = pass_pair(constrained)
    zs, us, lam, lam_t, mu, center, _ = port_args(pb, pparams)
    ks, Ks = t(ref["seq"][0][1])[None], t(ref["seq"][1][1])[None]
    got = pctrl.optimizer.forward_pass(zs[0, 0], zs, us, ks, Ks, lam, lam_t, mu, center,
                                       pparams)
    for name, g, r in zip(("costs", "controls", "trajectories"), got, ref["fwd"]):
        close(g[0], r, FWD_TOL, name)
    assert np.ptp(ref["fwd"][0]) > 1e-3  # the step sizes differ


@pytest.mark.parametrize("case", list(INNER_CASES))
@pytest.mark.parametrize("constrained", [False, True])
def test_inner_iteration_matches_jax(constrained, case):
    """One backward pass and line search: the accepted plan, its
    trajectory and cost, and the regularizer."""
    pctrl, pparams, pb, ref = pass_pair(constrained)
    i = list(INNER_CASES).index(case)
    offset, reg = INNER_CASES[case]
    zs, us, lam, lam_t, mu, center, _ = port_args(pb, pparams)
    cost = torch.tensor([ref["cost0"] + np.float32(offset)], dtype=torch.float32)
    got = pctrl.optimizer.inner_iteration(zs[0, 0], us, zs, cost,
                                          torch.tensor([reg], dtype=torch.float32), lam, lam_t,
                                          mu, center, pparams)
    r_us, r_zs, r_cost, r_reg = (a[i] for a in ref["inner"])
    close(got[0][0], r_us, STEP_TOL, "plan")
    close(got[1][0], r_zs, STEP_TOL, "trajectory")
    close(got[2], np.reshape(r_cost, 1), STEP_TOL, "cost")
    assert float(got[3][0]) == float(r_reg)
    assert float(r_reg) == {"improves": 0.5, "rejects": 10.0, "capped": 1e8}[case]
    if case != "improves":
        assert np.array_equal(got[0][0].numpy(), pb["us"])


def test_multiplier_update_matches_jax():
    """lam <- max(0, lam + mu c) along a trajectory, box and terminal set."""
    pctrl, pparams, pb, ref = pass_pair(True)
    zs, _, lam, lam_t, mu, center, _ = port_args(pb, pparams)
    got_lam, got_lam_t = pctrl.optimizer.multiplier_update(zs, lam, lam_t, mu, center)
    close(got_lam[0], ref["lam"], dict(rtol=1e-6, atol=1e-6), "stage multipliers")
    close(got_lam_t[0], ref["lam_t"], dict(rtol=1e-6, atol=1e-6), "terminal multipliers")
    assert (ref["lam"] == 0).any() and (ref["lam"] > 0).any()


# ---- the step: a whole step and its bookkeeping, from fed states -----------------------------
def port_state(jstate, generator=None) -> ILQRState:
    """The JAX optimizer's state as the port's."""
    return ILQRState(generator=generator or torch.Generator().manual_seed(0),
                     u_traj=t(jstate.u_traj), u_prev=t(jstate.u_prev), plan=t(jstate.plan),
                     j=torch.tensor(int(jstate.j)), count=int(jstate.count))


def assert_same_step(jopt, u_ref, popt, u, state, tol=STEP_TOL):
    """The port's step (u, its new state, its diagnostics) against the JAX
    step just taken by ``jopt``."""
    js, lv = jopt.opt_state, jopt.logging_values
    close(u, u_ref, tol, "u")
    close(state.plan, js.plan, tol, "plan")
    close(state.u_traj, js.u_traj, tol, "warm start")
    close(state.u_prev, js.u_prev, tol, "u_prev")
    assert int(state.j) == int(js.j) and state.count == int(js.count)
    for key in ("Q_logged", "J_logged", "rollout_trajectories_logged"):
        close(popt.logging_values[key], lv[key], tol, key)
    assert bool(popt.logging_values["solver_ok"]) == bool(lv["solver_ok"])


@pytest.mark.parametrize("riccati", ["sequential", "parallel"])
def test_whole_steps_match_jax(riccati):
    """Three steps at H=20 and 5 iterations, each from JAX's state (the
    plan and warm start the JAX step left): u, plan, warm start, J_logged."""
    jctrl, pctrl = make_pair(ilqr_config(H=20, riccati=riccati))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    s = np.array([0.1, 0.0, 0.25, 0.1], np.float32)
    for _ in range(3):
        popt.opt_state = port_state(jopt.opt_state)
        u_ref, u = jctrl.step(s), pctrl.step(s)
        assert_same_step(jopt, u_ref, popt, u, popt.opt_state)
        s = s + np.float32(0.02) * np.array([s[1], 0.5, s[3], -1.0], np.float32)


class QuadCost(CostFunction):
    """0.5 x'x + 0.5 r u'u (the JAX test's QuadCost)."""

    dynamic_config_keys = ("r",)
    DEFAULTS = {"r": 0.1}

    def __init__(self, config=None):
        super().__init__({**self.DEFAULTS, **(config or {})})

    def _stage_cost_core_soa(self, xs, us, params):
        r = params["cost"]["r"]
        return 0.5 * sum(x * x for x in xs) + 0.5 * r * sum(u * u for u in us)


class JaxQuadCost(JaxCostFunction):
    dynamic_config_keys = ("r",)
    DEFAULTS = {"r": 0.1}

    def __init__(self, config=None):
        super().__init__({**self.DEFAULTS, **(config or {})})

    def _stage_cost_core_soa(self, xs, us, params):
        r = params["cost"]["r"]
        return 0.5 * sum(x * x for x in xs) + 0.5 * r * sum(u * u for u in us)


def _double_integrator_derivs(xs, us, p):
    return (xs[1], us[0] * p["gain"])


def double_integrator(dt=0.1, port=True):
    """x'' = gain * u, Euler (the JAX test's make_double_integrator)."""
    if port:
        return ODEPredictor(dynamics=pdyn.soa_to_aos(_double_integrator_derivs, 2, 1),
                            num_states=2, num_control_inputs=1, dt=dt, integrator="euler",
                            params={"gain": 1.0})
    return JaxODEPredictor(dynamics=jdyn.soa_to_aos(_double_integrator_derivs, 2, 1),
                           num_states=2, num_control_inputs=1, dt=dt, integrator="euler",
                           params={"gain": 1.0})


def build_di(port=True, H=40, bounds=50.0, iters=30, r=0.1, logging=True, **extra):
    """The JAX test's build_ilqr over the double integrator, either package."""
    cfg = dict(mpc_horizon=H, max_iterations=iters, tol=1e-9, regularization_init=1.0,
               regularization_max=1e8, line_search_steps=8)
    cfg.update(extra)
    limits = (np.array([-bounds], np.float32), np.array([bounds], np.float32))
    if port:
        opt = ILQROptimizer(predictor=double_integrator(), cost_function=QuadCost({"r": r}),
                            control_limits=limits, optimizer_logging=logging, seed=0, **cfg)
        opt.device = CPU
    else:
        opt = JaxILQR(predictor=double_integrator(port=False),
                      cost_function=JaxQuadCost({"r": r}), control_limits=limits,
                      optimizer_logging=logging, seed=0, **cfg)
    opt.configure(num_states=2, num_control_inputs=1, dt=0.1)
    return opt


def di_params(port=True, gain=1.0, r=0.1, attrs=None):
    attrs = attrs or {}
    if port:
        return {"dyn": {"gain": torch.tensor(gain, dtype=torch.float32)},
                "cost": {"r": torch.tensor(r, dtype=torch.float32)},
                "attrs": {k: torch.tensor(v, dtype=torch.float32) for k, v in attrs.items()}}
    return {"dyn": {"gain": jnp.float32(gain)}, "cost": {"r": jnp.float32(r)},
            "attrs": {k: jnp.float32(v) for k, v in attrs.items()}}


def di_pair(**kw):
    return build_di(port=False, **kw), build_di(**kw)


def test_replay_after_a_nonfinite_solve_matches_jax():
    """The JAX test's scenario (a NaN gain twice, then a good solve) on both
    packages from the same states: the replayed controls plan[1], plan[2],
    the index, the kept plan, then the recovery."""
    jopt, popt = di_pair(H=10, iters=20)
    s = np.array([1.0, 0.0], np.float32)
    plan = None
    for i, gain in enumerate((1.0, np.nan, np.nan, 1.0)):
        popt.opt_state = port_state(jopt.opt_state)
        u_ref = jopt.step(s, params=di_params(False, gain))
        u = popt.step(s, params=di_params(True, gain))
        assert_same_step(jopt, u_ref, popt, u, popt.opt_state)
        if i == 0:
            plan = np.asarray(jopt.opt_state.plan).copy()  # fed to the port from here on
        elif i < 3:
            assert int(popt.opt_state.j) == i
            np.testing.assert_allclose(u, plan[i], atol=1e-6)
            np.testing.assert_array_equal(popt.opt_state.plan.numpy(), plan)
            assert not bool(popt.logging_values["solver_ok"])
    assert int(popt.opt_state.j) == 0 and not np.allclose(popt.opt_state.plan.numpy(), plan)


def lqr_policy_port(x, params):
    return torch.stack([-1.2 * x[0] - 1.9 * x[1]])


def lqr_policy_jax(x, params):
    return jnp.asarray([-1.2 * x[0] - 1.9 * x[1]])


def fed_state(H, seed, j, count, bounds=2.0):
    """A JAX state with a seeded plan and warm start."""
    rng = np.random.default_rng(seed)
    plan = rng.uniform(-bounds, bounds, (H, 1)).astype(np.float32)
    return JaxILQRState(u_traj=jnp.asarray(np.roll(plan, -1, 0)), u_prev=jnp.float32([0.3]),
                        plan=jnp.asarray(plan), j=jnp.int32(j), count=jnp.int32(count),
                        key=jax.random.PRNGKey(seed))


@pytest.mark.parametrize("j_fed", [0, 4, 8])
def test_failed_solve_extends_the_tail_with_the_policy_like_jax(j_fed):
    """A failed solve (a NaN cost weight: the dynamics stay finite) with a
    policy: the remaining plan, then the policy rolled through the
    dynamics, from a fed plan and replay index."""
    H = 10
    jopt, popt = (build_di(port=p, H=H, iters=3,
                           initial_guess_policy=lqr_policy_port if p else lqr_policy_jax)
                  for p in (False, True))
    s = np.array([0.7, -0.2], np.float32)
    jopt.opt_state = fed_state(H, 5, j_fed, 3)
    popt.opt_state = port_state(jopt.opt_state)
    u_ref = jopt.step(s, params=di_params(False, r=np.nan))
    u = popt.step(s, params=di_params(True, r=np.nan))
    assert_same_step(jopt, u_ref, popt, u, popt.opt_state)
    n_valid = H - (j_fed + 2)
    plan = np.asarray(jopt.opt_state.plan)
    np.testing.assert_array_equal(popt.opt_state.u_traj[:n_valid].numpy(),
                                  plan[j_fed + 2:j_fed + 2 + n_valid])
    assert not np.allclose(popt.opt_state.u_traj[n_valid:].numpy(), plan[-1])


def test_plan_exhaustion_resets_the_warm_start_like_jax():
    """Without a policy, a failure that reaches the plan's end replays its
    last control and resets the warm start to the box's middle."""
    H = 10
    jopt, popt = di_pair(H=H, iters=3)
    s = np.array([0.7, -0.2], np.float32)
    jopt.opt_state = fed_state(H, 6, H - 2, 7)
    popt.opt_state = port_state(jopt.opt_state)
    u_ref = jopt.step(s, params=di_params(False, gain=np.nan))
    u = popt.step(s, params=di_params(True, gain=np.nan))
    assert_same_step(jopt, u_ref, popt, u, popt.opt_state)
    assert int(popt.opt_state.j) == H - 1
    np.testing.assert_array_equal(popt.opt_state.u_traj.numpy(), np.zeros((H, 1), np.float32))
    np.testing.assert_array_equal(u, np.asarray(jopt.opt_state.plan)[H - 1])


def jax_multistart_draws(jopt):
    """The uniform draws JAX's multi-start step takes next (ilqr.py:546-555)."""
    n_extra = 2 if jopt.initial_guess_policy is not None else 1
    _, sub = jax.random.split(jopt.opt_state.key)
    shape = (max(jopt.n_starts - n_extra, 0) + 1, jopt.mpc_horizon, jopt.num_control_inputs)
    return np.asarray(jax.random.uniform(sub, shape, minval=jopt.action_low,
                                         maxval=jopt.action_high, dtype=jnp.float32))


@pytest.mark.parametrize("count", [0, 2])
@pytest.mark.parametrize("constrained", [False, True])
def test_multistart_selection_from_jax_draws(constrained, count):
    """Five starts (the warm start, the policy's or on the first step the
    spare draw, three draws) from JAX's own draws, one iteration each so
    they stay apart: the same start chosen, cheapest or feasible-first
    (a velocity box |v| <= 0.4 that the cheapest starts break)."""
    H = 10
    extra = dict(H=H, iters=1, n_starts=5, bounds=3.0)
    if constrained:
        extra.update(state_max=["inf", 0.4], al_iterations=1)
    jopt, popt = (build_di(port=p, initial_guess_policy=lqr_policy_port if p else
                           lqr_policy_jax, **extra) for p in (False, True))
    s = np.array([1.5, -0.5], np.float32)
    jopt.opt_state = fed_state(H, 7, 0, count, bounds=3.0)
    popt.opt_state = port_state(jopt.opt_state)
    draws = jax_multistart_draws(jopt)
    u_ref = jopt.step(s, params=di_params(False))
    u, state, diag = popt.update(popt.opt_state, torch.tensor(s)[None], di_params(True),
                                 t(draws))
    close(u, u_ref, STEP_TOL, "u")
    close(state.plan, jopt.opt_state.plan, STEP_TOL, "plan")
    close(diag["J_logged"], jopt.logging_values["J_logged"], STEP_TOL, "J")
    # The starts' solutions differ, so the plans agreeing names one start.
    z0 = torch.tensor([1.5, -0.5, 0.3])
    heads = [popt.policy_guess(z0, di_params(True)) if count == 0
             else popt.opt_state.u_traj, t(draws[-1]) if count == 0
             else popt.policy_guess(z0, di_params(True))]
    us0 = torch.cat([torch.stack(heads), t(draws[:-1])])
    solved = popt.solve(z0, us0, torch.zeros(0), di_params(True))
    gaps = (solved - state.plan).abs().amax(dim=(1, 2))
    assert int((gaps < 1e-4).sum()) == 1 and float(gaps.sort().values[1]) > 1e-2


# ---- the JAX package's behaviour tests (tests/test_ilqr.py), at their configurations ----------
def test_step_contract():
    """K forced to 1 and the logging keys' shapes (``tests/test_optimizer_zoo.py:185``)."""
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "ilqr",
                                 "controller_logging": True})
    ctrl.configure(optimizer_name="ilqr", optimizer_config={
        "seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 12, "num_rollouts": 1,
        "max_iterations": 5, "tol": 1e-7, "regularization_init": 1.0,
        "regularization_max": 1e8, "line_search_steps": 4})
    u = ctrl.step(np.array([0.0, 0.0, 0.15, 0.0], np.float32))
    lv = ctrl.optimizer.logging_values
    assert ctrl.optimizer.num_rollouts == 1
    assert lv["Q_logged"].shape == (1, 12, 1) and lv["J_logged"].shape == (1,)
    assert lv["rollout_trajectories_logged"].shape == (1, 13, 4)
    assert -1.0 <= float(u[0]) <= 1.0


def test_matches_lqr_on_double_integrator():
    from test_ilqr import lqr_gain

    opt = build_di()
    dt = 0.1
    A = np.array([[1.0, dt], [0.0, 1.0]], np.float32)
    B = np.array([[0.0], [dt]], np.float32)
    K = lqr_gain(A, B, np.eye(2, dtype=np.float32), np.array([[0.1]], np.float32))
    for x0 in ([1.0, 0.0], [0.5, -1.0], [-2.0, 0.3]):
        s = np.array(x0, np.float32)
        u = opt.step(s, params=di_params())
        u_lqr = float(-(K @ s)[0])
        assert abs(float(u[0]) - u_lqr) < 0.05 * max(1.0, abs(u_lqr)), (x0, u, u_lqr)


def test_cost_decreases_monotonically():
    opt = build_di(iters=2)
    s = np.array([2.0, 0.0], np.float32)
    opt.step(s, params=di_params())
    j2 = float(opt.logging_values["J_logged"][0])
    opt.optimizer_reset()
    opt.max_iterations = 30
    opt._build()
    opt.step(s, params=di_params())
    assert float(opt.logging_values["J_logged"][0]) <= j2 + 1e-6


def test_state_box_constraint_active_at_optimum():
    s = np.array([2.0, 0.0], np.float32)
    free = build_di(H=30, iters=40, r=0.001)
    free.step(s, params=di_params(r=0.001))
    v_free = np.abs(free.logging_values["rollout_trajectories_logged"][0, :, 1])
    assert v_free.max() > 0.8, "premise: the unconstrained plan exceeds the bound"
    vmax = 0.6
    con = build_di(H=30, iters=40, r=0.001, state_max=["inf", vmax], al_iterations=5,
                   mu_init=10.0, mu_growth=10.0)
    con.step(s, params=di_params(r=0.001))
    v_con = np.abs(con.logging_values["rollout_trajectories_logged"][0, :, 1])
    assert v_con.max() <= vmax + 0.02, v_con.max()
    assert v_con.max() > 0.5 * vmax


def test_terminal_set_reached():
    opt = build_di(H=25, iters=40, r=10.0, terminal_set_width=0.05, idx_terminal_set=[0],
                   terminal_set_center=["target_position"], al_iterations=5, mu_init=10.0,
                   mu_growth=10.0)
    opt.step(np.zeros(2, np.float32),
             params=di_params(r=10.0, attrs={"target_position": 1.5}))
    x_final = float(opt.logging_values["rollout_trajectories_logged"][0, -1, 0])
    assert abs(x_final - 1.5) <= 0.05 + 0.01, x_final


def test_includes_control_change_cost():
    """A heavy ccrc weight smooths the plan (the NLP slot optimizes the
    sampling optimizers' objective)."""
    from control_toolkit_tpu_torch.costs.cartpole import CartpoleQuadraticCost

    def solve_with(ccrc_weight):
        pred = ODEPredictor(dynamics=pdyn.cartpole_dynamics, num_states=4,
                            num_control_inputs=1, dt=0.02, integrator="rk4",
                            params=dict(pdyn.CARTPOLE_DEFAULTS))
        cost = CartpoleQuadraticCost({"ccrc_weight": ccrc_weight})
        opt = ILQROptimizer(predictor=pred, cost_function=cost, control_limits=LIMITS,
                            optimizer_logging=True, seed=0, mpc_horizon=30, max_iterations=25,
                            tol=1e-9, regularization_init=1.0, regularization_max=1e8,
                            line_search_steps=8)
        opt.device = CPU
        opt.configure(num_states=4, num_control_inputs=1, dt=0.02)
        params = {"dyn": {k: torch.tensor(v, dtype=torch.float32)
                          for k, v in pdyn.CARTPOLE_DEFAULTS.items()},
                  "cost": cost.current_params()["cost"],
                  "attrs": {"target_position": torch.tensor(0.0)}}
        opt.step(np.array([0.0, 0.0, 0.35, 0.0], np.float32), params=params)
        return np.abs(np.diff(opt.logging_values["Q_logged"][0, :, 0])).max()

    rough, smooth = solve_with(0.0), solve_with(500.0)
    assert smooth < 0.5 * rough, (smooth, rough)


def cartpole_ilqr(riccati, H=30, **extra):
    """The JAX test's _make_cartpole_ilqr, on the CPU."""
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "max_iterations": 20,
           "al_iterations": 1, "line_search_steps": 8, "n_starts": 1, "riccati": riccati}
    cfg.update(extra)
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "ilqr",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="ilqr", optimizer_config=cfg)
    return ctrl


def test_closed_loop_cartpole():
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"device": "cpu", "optimizer": "ilqr",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="ilqr", optimizer_config={
        "seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 40, "num_rollouts": 1,
        "max_iterations": 15, "tol": 1e-7, "regularization_init": 1.0,
        "regularization_max": 1e8, "line_search_steps": 6})
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=7)
    s, _ = env.reset()
    for _ in range(50):
        s, *_ = env.step(ctrl.step(s[0]))
    assert abs(float(s[0, 2])) < 0.1, f"ilqr failed to stabilize: {s[0]}"


def test_parallel_riccati_closed_loop():
    ctrl = cartpole_ilqr("parallel", H=40)
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=5)
    s, _ = env.reset()
    for _ in range(50):
        s, *_ = env.step(ctrl.step(s[0]))
    assert abs(float(s[0, 2])) < 0.4, f"pole fell: {s[0]}"


def test_heuristic_policy_initial_guess():
    """(a) the policy's plan seeds a one-iteration solve elsewhere than the
    mid-range default; both converge to one optimum with 30; (b) multi-start
    with the policy start runs and is finite."""
    s = np.array([1.5, -0.5], np.float32)

    def build(policy, n_starts=1, iters=1):
        return build_di(H=20, iters=iters, line_search_steps=4, n_starts=n_starts,
                        initial_guess_policy=policy, logging=False)

    u_pol = build(lqr_policy_port).step(s, params=di_params())
    u_mid = build(None).step(s, params=di_params())
    assert np.all(np.isfinite(u_pol)) and np.all(np.isfinite(u_mid))
    assert not np.allclose(u_pol, u_mid)
    np.testing.assert_allclose(build(lqr_policy_port, iters=30).step(s, params=di_params()),
                               build(None, iters=30).step(s, params=di_params()), atol=1e-3)
    u3 = build(lqr_policy_port, n_starts=3, iters=10).step(s, params=di_params())
    assert np.all(np.isfinite(u3))
