"""The pendulum, acrobot and point-mass plants of the port against the JAX
package: their dynamics (exact and ``.fast``), the seven cost names, the
mirrored dynamics keys, the environments, the hand-written adjoints, the
plain versions of K1, K2, K3 and K7 over each (dynamics, cost) plant
against the JAX kernels in interpret mode, one MPPI and one rpgd-tf update
fed the JAX draws, and the gates: every path on which the JAX package
would launch a kernel that has no instance of these plants raises,
naming the kernel and the plant, and never takes the scan instead.

Tolerances, each with its reason:

* the dynamics, costs and environment steps to DERIVS_TOL: the same
  float32 operations in the same order; XLA's and torch's sin and cos
  differ by an ulp;
* the adjoints to ``torch.autograd`` in float64 to F64_TOL (rounding
  only), the ``maximum`` ties to ``jax.grad``'s split exactly;
* the kernels' plain versions and the optimizer steps to the bounds of
  the cartpole tests they follow (test_torch_kernels.py, test_torch_grad.py,
  test_torch_fused_mppi.py, test_torch_mppi.py, test_torch_rpgd.py): the
  plants change the terms, not the sums.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import dynamics as jdyn
from control_toolkit_tpu.ops.pallas_mppi import ROWS
from control_toolkit_tpu.utils import registry as jregistry
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.pendulum import PendulumQuadraticCost
from control_toolkit_tpu_torch.costs.value_terminal import attach_value_terminal
from control_toolkit_tpu_torch.models import dynamics as pdyn
from control_toolkit_tpu_torch.ops import adjoints, kernels
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.fused_mppi import fused_mppi_step
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils import registry
from control_toolkit_tpu_torch.utils.convert import (
    mppi_state_from_numpy, params_from_numpy, rpgd_state_from_numpy,
)
from test_torch_fused_mppi import K3_COST_TOL
from test_torch_grad import GRAD_TOL
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import (
    CPU, COST_TOL, UNOM_TOL, jax_next_draw, jax_params_numpy, port_noise,
)
from test_torch_rpgd import MOMENT_TOL, Q_TOL, jax_rpgd_draw

K, H, TILE = 256, 20, 64
DERIVS_TOL = dict(rtol=2e-6, atol=2e-6)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
OBSTACLES = {"obs0_x": 0.2, "obs0_y": -0.1, "obs0_r": 0.25, "obs1_x": -0.35, "obs1_y": 0.3,
             "obs1_r": 0.15}
TARGET = {"target_x": 0.5, "target_y": -0.3}
# label: (environment, cost specification, device plant, attributes)
PLANTS = {
    "pendulum": ("pendulum", None, "pendulum", {}),
    "acrobot": ("acrobot", None, "acrobot", {}),
    "pointmass": ("pointmass", None, "pointmass", TARGET),
    "pointmass_obstacles": ("pointmass", "obstacles", "pointmass_obstacles",
                            {**TARGET, **OBSTACLES}),
}
DIMS = {"pendulum": (2, 1), "acrobot": (4, 1), "pointmass": (4, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def limits(env):
    U = DIMS[env][1]
    return np.full(U, -1.0, np.float32), np.full(U, 1.0, np.float32)


def mppi_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
           "cc_weight": 1.0, "R": 1.0, "LBD": 5.0, "NU": 1000.0, "SQRTRHOINV": 0.2,
           "period_interpolation_inducing_points": 5}
    cfg.update(extra)
    return cfg


def rpgd_config(**extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": 15, "num_rollouts": 128,
           "outer_its": 2, "SAMPLING_DISTRIBUTION": "uniform",
           "period_interpolation_inducing_points": 5, "learning_rate": 0.05,
           "gradmax_clip": 5, "opt_keep_k_ratio": 0.25, "resamp_per": 10,
           "sample_stdev": 0.5, "warmup": False, "warmup_iterations": 3}
    cfg.update(extra)
    return cfg


def port_ctrl(label, optimizer="mppi", cfg=None, spec="ODE", cls=MPCController, **configure):
    env, cost, _, attrs = PLANTS[label]
    ctrl = cls(env, limits(env), dict(attrs),
               config={"device": "cpu", "optimizer": optimizer, "controller_logging": False,
                       "cost_function_specification": cost})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=dict(cfg or mppi_config()), **configure)
    return ctrl


def make_pair(label, optimizer="mppi", cfg=None, spec="ODE", jax_logging=False):
    env, cost, _, attrs = PLANTS[label]
    jctrl = JaxMPC(env, limits(env), dict(attrs),
                   config={"optimizer": optimizer, "controller_logging": jax_logging,
                           "cost_function_specification": cost})
    jctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(cfg or mppi_config()))
    return jctrl, port_ctrl(label, optimizer, cfg, spec)


def states(label, rng, n):
    """Start states of each plant: the pendulum around hanging, the acrobot
    and the point mass around rest (an obstacle's margin included)."""
    env = PLANTS[label][0]
    if env == "pendulum":
        x = np.stack([np.pi + 0.8 * rng.standard_normal(n), 2.0 * rng.standard_normal(n)], 1)
    elif env == "acrobot":
        x = 0.6 * rng.standard_normal((n, 4))
    else:
        x = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)), rng.standard_normal((n, 2))], 1)
    return x.astype(np.float32)


_PAIRS = {}


def pair(label, spec="ODE"):
    """The MPPI pair of a plant, with the JAX params in both forms (built
    once a module)."""
    if (label, spec) not in _PAIRS:
        jctrl, pctrl = make_pair(label, spec=spec)
        jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                         jctrl._assemble_params())
        _PAIRS[label, spec] = (jctrl, pctrl, jparams,
                               params_from_numpy(jax_params_numpy(jctrl), CPU))
    return _PAIRS[label, spec]


# ---- dynamics ------------------------------------------------------------------------------
@pytest.mark.parametrize("env", ["pendulum", "acrobot", "pointmass"])
@pytest.mark.parametrize("fast", [False, True])
def test_derivs_match_jax(env, fast):
    """models/dynamics.py's derivs (and ``.fast``) against the JAX ones on
    the same seeded states, controls and constants (two sets: the defaults
    and a perturbed copy)."""
    rng = np.random.default_rng(1)
    S, U = DIMS[env]
    x = (2.0 * rng.standard_normal((512, S))).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, (512, U)).astype(np.float32)
    jfn, jdefaults, *_ = jdyn.DYNAMICS[env]
    pfn, pdefaults, S2, U2 = pdyn.DYNAMICS[env]
    assert (S2, U2) == (S, U) and pdefaults == jdefaults
    assert pdyn.STATE_NAMES[env] == jdyn.STATE_NAMES[env]
    assert pdyn.CONTROL_NAMES[env] == jdyn.CONTROL_NAMES[env]
    if fast:
        jfn, pfn = jfn.fast, pfn.fast
    for scale in (1.0, 1.3):
        p = {k: np.float32(v * scale) for k, v in jdefaults.items()}
        ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(u), {k: jnp.float32(v)
                                                                for k, v in p.items()}))
        got = pfn(torch.tensor(x), torch.tensor(u),
                  {k: torch.tensor(v) for k, v in p.items()}).numpy()
        np.testing.assert_allclose(got, ref, **DERIVS_TOL)
    if env == "pointmass":
        assert pdyn.pointmass_dynamics.fast is pdyn.pointmass_dynamics


def plant_p64(plant):
    """A plant's packed parameters by key in float64: the defaults of its
    dynamics and cost, the targets and obstacles of PLANTS."""
    label = "pointmass_obstacles" if plant == "pointmass_obstacles" else plant.split("_")[0]
    env, cost, _, attrs = PLANTS[label]
    ctrl = port_ctrl(label)
    model, pack = ode.rollout_model(ctrl.optimizer)
    pvec = pack(ctrl._assemble_params(), torch.full((DIMS[env][1],), 0.1))
    return {k: pvec[i].double() for i, k in enumerate(model.param_keys)}, model


def f64_inputs(S, U, seed, n=64):
    rng = np.random.default_rng(seed)
    xs = tuple(torch.tensor(1.5 * rng.standard_normal(n)) for _ in range(S))
    us = tuple(torch.tensor(rng.uniform(-1.0, 1.0, n)) for _ in range(U))
    return xs, us


@pytest.mark.parametrize("plant", ["pendulum", "pendulum_fast", "acrobot", "acrobot_fast",
                                   "pointmass"])
def test_derivs_jac_and_vjp_match_autograd_f64(plant):
    """Each plant's Jacobian (K7's forward-mode tangents) and VJP against
    torch.autograd of its derivs in float64; the fast plants' take the
    polynomials' derivatives, as jax.vjp does through ops/fastmath.py."""
    env = plant.split("_")[0]
    S, U = DIMS[env]
    p, _ = plant_p64(env)
    dyn = {k[2:]: v for k, v in p.items() if k.startswith("d_")}
    fn = pdyn.DYNAMICS[env][0]
    fn = fn.fast if plant.endswith("_fast") else fn
    xs, us = f64_inputs(S, U, 2)
    xu = torch.stack(xs + us, dim=1).requires_grad_(True)
    f = fn.soa(tuple(xu[:, i] for i in range(S)), tuple(xu[:, S + j] for j in range(U)), dyn)
    auto = torch.stack([torch.autograd.grad(fi.sum(), xu, retain_graph=True)[0] for fi in f], 1)
    fj, J = adjoints.PLANT_JACOBIANS[plant](xs, us, p)
    torch.testing.assert_close(J, auto, **F64_TOL)
    torch.testing.assert_close(torch.stack(fj, 1), torch.stack(f, 1).detach(), **F64_TOL)
    lam = f64_inputs(S, 0, 3)[0]
    dx, du = adjoints.PLANT_ADJOINTS[plant][0](xs, us, p, lam)
    ref = torch.einsum("ks,ksn->kn", torch.stack(lam, 1), auto)
    torch.testing.assert_close(torch.stack(dx + du, 1), ref, **F64_TOL)


@pytest.mark.parametrize("plant", ["pendulum", "acrobot", "pointmass", "pointmass_obstacles"])
def test_cost_adjoints_match_autograd_f64(plant):
    """The stage cost's (gx, gu, gprev) and the terminal gradient against
    torch.autograd of the model's stage and terminal callables in float64,
    on states that put the acrobot's hinge and the obstacles' both sides of
    their ties."""
    p, model = plant_p64(plant)
    S, U = kernels.PLANT_DIMS[plant]
    xs, us = f64_inputs(S, U, 4, n=256)
    if plant.startswith("pointmass"):
        xs = (0.4 * xs[0], 0.4 * xs[1]) + xs[2:]
    prev = f64_inputs(S, U, 5, n=256)[1]
    ct = 1.0 / 21.0
    z = torch.stack(xs + us + prev, dim=1).requires_grad_(True)
    parts = (tuple(z[:, i] for i in range(S)), tuple(z[:, S + j] for j in range(U)),
             tuple(z[:, S + U + j] for j in range(U)))
    (auto,) = torch.autograd.grad(ct * model.stage(*parts, p).sum(), z)
    _, stage_vjp, terminal_grad = adjoints.PLANT_ADJOINTS[plant]
    gx, gu, gp = stage_vjp(xs, us, prev, p, ct)
    torch.testing.assert_close(torch.stack(gx + gu + gp, 1), auto, **F64_TOL)
    zx = torch.stack(xs, 1).requires_grad_(True)
    # (+ 0 * zx: pendulum and acrobot have no terminal term, zeros_like(x))
    (auto_t,) = torch.autograd.grad(
        ct * model.terminal(tuple(zx[:, i] for i in range(S)), p).sum() + 0.0 * zx.sum(), zx)
    torch.testing.assert_close(torch.stack(terminal_grad(xs, p, ct), 1), auto_t, **F64_TOL)


def test_maximum_ties_split_like_jax_vjp():
    """At a ``maximum``'s tie jax.vjp gives each side half the cotangent:
    ``_tie`` is jax.grad's, and at the acrobot's hinge tie (height 0) and
    an obstacle's (a state on its margin) the adjoints equal jax.vjp of the
    JAX costs there."""
    for v in (-1.0, 0.0, 2.0):
        ref = float(jax.grad(lambda a: jnp.maximum(a, 0.0))(jnp.float32(v)))
        assert float(adjoints._tie(torch.tensor(v))) == ref
        ref = float(jax.grad(lambda a: jnp.maximum(0.0, a))(jnp.float32(v)))
        assert float(adjoints._tie(torch.tensor(v))) == ref
    jregistry._load_builtins()
    for plant, x, attrs in (
            ("acrobot", [0.0, 0.7, np.pi, -0.4], {}),
            ("pointmass_obstacles", [0.5, 0.0, 0.3, -0.2],
             {"obs0_x": 0.0, "obs0_y": 0.0, "obs0_r": 0.25})):
        p, model = plant_p64(plant)
        if attrs:
            p = {**p, **{f"a_{k}": torch.tensor(v, dtype=torch.float64) for k, v in attrs.items()},
                 "c_clearance": torch.tensor(0.25, dtype=torch.float64)}
        S, U = kernels.PLANT_DIMS[plant]
        xs = tuple(torch.tensor([v], dtype=torch.float64) for v in x)
        us = tuple(torch.tensor([0.3], dtype=torch.float64) for _ in range(U))
        if plant == "acrobot":
            hm = -p["c_l1"] * xs[0].cos() - p["c_l2"] * (xs[0] + xs[2]).cos()
        else:
            hm = 1.0 - (xs[0] ** 2 + xs[1] ** 2) / (p["c_clearance"] + p["a_obs0_r"]) ** 2
        assert float(hm) == 0.0  # the tie itself
        gx, _, _ = adjoints.PLANT_ADJOINTS[plant][1](xs, us, us, p, 1.0)
        jcls = jregistry.cost_functions.get(
            "acrobot/default" if plant == "acrobot" else "pointmass/obstacles")
        jcost = jcls({k[2:]: float(v) for k, v in p.items() if k.startswith("c_")})
        jp = {"cost": {k[2:]: jnp.float32(v) for k, v in p.items() if k.startswith("c_")},
              "attrs": {k[2:]: jnp.float32(v) for k, v in p.items() if k.startswith("a_")}}
        xj = jnp.asarray(np.array(x, np.float32))
        ref = jax.grad(lambda xx: jcost._stage_cost_core_soa(
            tuple(xx[i] for i in range(S)), tuple(jnp.float32(0.3) for _ in range(U)),
            jp))(xj)
        np.testing.assert_allclose(torch.stack(gx, 1)[0].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


# ---- costs ---------------------------------------------------------------------------------
COST_NAMES = {
    "pendulum/default": "pendulum", "pendulum/quadratic": "pendulum",
    "acrobot/default": "acrobot", "pointmass/default": "pointmass",
    "pointmass/quadratic": "pointmass", "pointmass/obstacles": "pointmass",
    "pointmass/trajectory": "pointmass",
}


@pytest.mark.parametrize("name", sorted(COST_NAMES))
def test_cost_names_match_jax(name):
    """Each of the seven cost names' stage, terminal and trajectory costs
    (and ``cost_components`` where the JAX class has it) against the JAX
    class over the same config, attributes and seeded trajectories."""
    env = COST_NAMES[name]
    S, U = DIMS[env]
    registry._load_builtins()
    jregistry._load_builtins()
    pcls, jcls = registry.cost_functions.get(name), jregistry.cost_functions.get(name)
    cfg = {"energy_weight": 0.07} if env == "pendulum" else {}
    pcost, jcost = pcls(dict(cfg)), jcls(dict(cfg))
    Hc = 12
    pcost.configure(batch_size=16, horizon=Hc)
    jcost.configure(batch_size=16, horizon=Hc)
    rng = np.random.default_rng(6)
    traj = (1.2 * rng.standard_normal((16, Hc + 1, S))).astype(np.float32)
    Q = rng.uniform(-1.0, 1.0, (16, Hc, U)).astype(np.float32)
    u_prev = rng.uniform(-1.0, 1.0, (U,)).astype(np.float32)
    attrs = {}
    if env == "pointmass":
        attrs = {**TARGET, **OBSTACLES}
        if name == "pointmass/trajectory":
            attrs = {"ref_x": rng.standard_normal(Hc + 1).astype(np.float32),
                     "ref_y": rng.standard_normal(Hc + 1).astype(np.float32)}
    jp = jcost.current_params(attrs={k: jnp.asarray(v, jnp.float32) for k, v in attrs.items()})
    pp = pcost.current_params(attrs={k: torch.as_tensor(np.float32(v) if np.ndim(v) == 0 else v)
                                     for k, v in attrs.items()})
    assert set(pp["cost"]) == set(jp["cost"])
    for field in ("dynamic_config_keys", "attr_keys", "attr_defaults", "mirrored_dynamics_keys"):
        pv, jv = getattr(pcost, field), getattr(jcost, field)
        if field == "attr_defaults":
            pv = {k: np.asarray(v) for k, v in pv.items()}
            jv = {k: np.asarray(v) for k, v in jv.items()}
            assert pv.keys() == jv.keys() and all(np.array_equal(pv[k], jv[k]) for k in pv)
        else:
            assert tuple(pv) == tuple(jv), field
    assert pcost.supports_fused_rollout == jcost.supports_fused_rollout
    got = pcost.get_trajectory_cost(torch.tensor(traj), torch.tensor(Q), torch.tensor(u_prev), pp)
    ref = jcost.get_trajectory_cost(jnp.asarray(traj), jnp.asarray(Q), jnp.asarray(u_prev), jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DERIVS_TOL)
    got = pcost.get_stage_cost(torch.tensor(traj[:, :-1]), torch.tensor(Q), None, pp)
    ref = jcost.get_stage_cost(jnp.asarray(traj[:, :-1]), jnp.asarray(Q), None, jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DERIVS_TOL)
    got = pcost.get_terminal_cost(torch.tensor(traj[:, -1]), pp)
    ref = jcost.get_terminal_cost(jnp.asarray(traj[:, -1]), jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DERIVS_TOL)
    if hasattr(jcost, "cost_components"):
        gotc = pcost.cost_components(torch.tensor(traj[:, :-1]), torch.tensor(Q), None, pp)
        refc = jcost.cost_components(jnp.asarray(traj[:, :-1]), jnp.asarray(Q), None, jp)
        assert gotc.keys() == refc.keys()
        for k in refc:
            np.testing.assert_allclose(gotc[k].numpy(), np.asarray(refc[k]), **DERIVS_TOL)


def test_sync_with_dynamics_seeds_and_warns(caplog):
    """Unset mirrored keys are seeded from the dynamics (a residual
    predictor's from its base); an explicit value that differs is kept,
    with a warning; MPCController.configure calls the sync."""
    cost = PendulumQuadraticCost({"m": 1.0})
    with caplog.at_level(logging.WARNING):
        cost.sync_with_dynamics({"base": {"m": 2.0, "L": 0.7, "g": 9.0}, "res": {}})
    assert (cost.config["m"], cost.config["L"], cost.config["g"]) == (1.0, 0.7, 9.0)
    assert "differs from the dynamics m=2.0" in caplog.text
    caplog.clear()
    cost = PendulumQuadraticCost()
    cost.sync_with_dynamics({"m": 2.0, "L": 0.7})
    assert (cost.config["m"], cost.config["L"], cost.config["g"]) == (2.0, 0.7, 9.81)
    assert not caplog.text
    cost.sync_with_dynamics("not a dict")  # nothing to mirror
    ctrl = port_ctrl("pendulum", cfg=mppi_config(num_rollouts=16, mpc_horizon=5),
                     predictor_config={"params": {"m": 1.5, "L": 0.8}})
    assert ctrl.cost_function.cost_function.config["m"] == 1.5
    assert ctrl.cost_function.cost_function.config["L"] == 0.8
    jctrl = JaxMPC("pendulum", limits("pendulum"), {},
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", optimizer_config=mppi_config(num_rollouts=16,
                                                                         mpc_horizon=5),
                    predictor_config={"params": {"m": 1.5, "L": 0.8}})
    assert jctrl.cost_function.cost_function.config["m"] == 1.5


# ---- environments --------------------------------------------------------------------------
@pytest.mark.parametrize("env", ["pendulum", "acrobot", "pointmass"])
def test_environment_step_matches_jax(env):
    """One rk4 step of each environment, its reward and (the point mass)
    its termination, against the JAX environment from the same state and
    action; a reset gives the documented start."""
    from control_toolkit_tpu.utils.registry import environments as jenvs

    registry._load_builtins()
    jregistry._load_builtins()
    penv = registry.environments.get(env)(batch_size=8, seed=0)
    jenv = jenvs.get(env)(batch_size=8, seed=0)
    S, U = DIMS[env]
    assert (penv.num_states, penv.num_actions) == (S, U) and penv.dt == jenv.dt
    rng = np.random.default_rng(7)
    x = (1.5 * rng.standard_normal((8, S))).astype(np.float32)
    x[0, :2] = 25.0  # out of the point mass's box
    a = rng.uniform(-1.0, 1.0, (8, U)).astype(np.float32)
    got = penv.step_dynamics(torch.tensor(x), torch.tensor(a), penv.dt).numpy()
    ref = np.asarray(jenv.step_dynamics(jnp.asarray(x), jnp.asarray(a), jenv.dt))
    np.testing.assert_allclose(got, ref, **DERIVS_TOL)
    np.testing.assert_allclose(penv.get_reward(torch.tensor(x), torch.tensor(a)).numpy(),
                               np.asarray(jenv.get_reward(jnp.asarray(x), jnp.asarray(a))),
                               **DERIVS_TOL)
    np.testing.assert_array_equal(penv.is_done(torch.tensor(x)).numpy(),
                                  np.asarray(jenv.is_done(jnp.asarray(x))))
    s, _ = penv.reset()
    assert s.shape == (8, S) and np.all(np.isfinite(s))
    if env == "pendulum":
        assert np.all(np.abs(s[:, 0] - np.pi) < 0.5)
    elif env == "pointmass":
        assert np.all(np.abs(s[:, :2]) <= 2.0) and np.all(s[:, 2:] == 0.0)
    s1, r, done, trunc, _ = penv.step(np.zeros(U, np.float32))
    assert s1.shape == (8, S) and r.shape == (8,) and done.shape == (8,)


def test_registry_resolves_the_new_names():
    registry._load_builtins()
    for name in COST_NAMES:
        assert name in registry.cost_functions
    for env in ("pendulum", "acrobot", "pointmass"):
        assert env in registry.environments


# ---- the kernels' plain versions against the JAX kernels in interpret mode -----------------
@pytest.mark.parametrize("label", sorted(PLANTS))
def test_packed_params_and_k1_plain_match_pallas_interpret(label):
    """The packed layout and values against JAX's ``_soa_bindings``, then
    K1's plain version against the JAX cost kernel in interpret mode (tile
    64, as tests/test_pallas_rollout.py:61 runs it) and the fused scan."""
    jctrl, pctrl, jparams, params = pair(label)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    env, _, plant, _ = PLANTS[label]
    S, U = DIMS[env]
    jkeys, jpack, *_ = jopt._soa_bindings()
    model, pack = ode.rollout_model(popt)
    assert model.plant == plant and list(model.param_keys) == list(jkeys)
    assert tuple(jkeys) == kernels.PLANT_PARAM_KEYS[plant]
    u_prev = np.linspace(0.1, 0.25, U).astype(np.float32)
    np.testing.assert_array_equal(pack(params, torch.as_tensor(u_prev)).numpy(),
                                  np.asarray(jpack(jparams, jnp.asarray(u_prev))))
    assert ode.can_use_cost(popt) and ode.can_use_grad(popt)
    rng = np.random.default_rng(0)
    s_tiled = states(label, rng, K)
    Q = rng.uniform(-1.0, 1.0, (K, H, U)).astype(np.float32)
    pallas = jopt._build_pallas_cost(interpret=True, tile_k=TILE)
    args = (jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    ref_kernel, ref_scan = np.asarray(pallas(*args)), np.asarray(jopt._fused_cost(*args))
    got = cost_rollout(model, torch.as_tensor(s_tiled), torch.as_tensor(Q),
                       pack(params, torch.as_tensor(u_prev))).numpy()
    np.testing.assert_allclose(got, ref_kernel, **COST_TOL)
    np.testing.assert_allclose(got, ref_scan, **COST_TOL)


@pytest.mark.parametrize("label", sorted(PLANTS))
def test_k2_plain_matches_pallas_semi_fused_interpret(label):
    """K2's plain version against the JAX semi-fused kernel
    (``make_run.external``) on the same noise: the point mass's two inputs
    walk the [P, U, K] layout."""
    jctrl, pctrl, jparams, params = pair(label)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    _, jpack, _ = jopt._build_fused_mppi(interpret=True, tile_k=TILE, build_step=False)
    cost_run = jopt._last_fused_make_run.external(K)
    P, U = jopt.interp.number_of_interpolation_inducing_points, popt.num_control_inputs
    T, C = K // TILE, TILE // ROWS
    rng = np.random.default_rng(5)
    eps_tiles = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    s0 = states(label, rng, 1)[0]
    u_nom = rng.uniform(-0.4, 0.4, (H, U)).astype(np.float32)
    u_prev = np.full(U, 0.2, np.float32)
    costs2d = np.asarray(cost_run(jnp.asarray(s0), jnp.asarray(u_nom),
                                  jpack(jparams, jnp.asarray(u_prev)), jnp.asarray(eps_tiles)))
    ref = costs2d.reshape(ROWS, T, C).transpose(1, 0, 2).reshape(K)
    eps = eps_tiles.reshape(T, U, P, ROWS, C).transpose(2, 1, 0, 3, 4).reshape(P, U, K)
    model, pack = ode.rollout_model(popt)
    got = mppi_cost(model, torch.as_tensor(s0), torch.as_tensor(u_nom),
                    pack(params, torch.as_tensor(u_prev)), torch.as_tensor(eps),
                    popt.interp.matrix, popt.action_low, popt.action_high,
                    popt.cc_weight, popt.R, popt.NU).numpy()
    np.testing.assert_allclose(got, ref, **COST_TOL)


@pytest.mark.parametrize("label", sorted(PLANTS))
def test_k7_plain_matches_pallas_grad_interpret_and_autograd(label):
    """K7's plain version (the hand-written adjoints) against the JAX
    gradient kernel in interpret mode (tile 64, as
    tests/test_pallas_grad.py:37 runs it; its jax.vjp backward) and against
    torch.autograd through K1's plain version in float64."""
    Kg, Hg = 128, 15
    jctrl, pctrl = make_pair(label, "rpgd-tf", rpgd_config(num_rollouts=Kg, mpc_horizon=Hg),
                             jax_logging=True)
    popt = pctrl.optimizer
    U = popt.num_control_inputs
    rng = np.random.default_rng(4)
    s0 = states(label, rng, Kg)
    Q = rng.uniform(-0.8, 0.8, (Kg, Hg, U)).astype(np.float32)
    u_prev = np.full(U, 0.1, np.float32)
    kernel = jctrl.optimizer._build_pallas_grad(interpret=True, tile_k=TILE)
    ref_cost, ref_grad = map(np.asarray, kernel(jnp.asarray(s0), jnp.asarray(Q),
                                                jnp.asarray(u_prev), jctrl._assemble_params()))
    assert ode.can_use_grad(popt)
    model, pack = ode.rollout_model(popt)
    pvec = pack(params_from_numpy(jax_params_numpy(jctrl), CPU), torch.as_tensor(u_prev))
    cost, dQ = grad_cost_rollout(model, torch.as_tensor(s0), torch.as_tensor(Q), pvec)
    np.testing.assert_allclose(cost.numpy(), ref_cost, **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), ref_grad, **GRAD_TOL)
    Q64 = torch.tensor(Q, dtype=torch.float64, requires_grad=True)
    s64, p64 = torch.tensor(s0, dtype=torch.float64), pvec.double()
    (auto,) = torch.autograd.grad(cost_rollout_plain(model, s64, Q64, p64).sum(), Q64)
    _, dQ64 = grad_cost_rollout_plain(model, s64, Q64.detach(), p64)
    torch.testing.assert_close(dQ64, auto, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("label,spec", [("pendulum", "ODE:rk4:1:fast"),
                                        ("pointmass", "ODE:rk4:1:fast"),
                                        ("acrobot", "ODE")])
def test_k3_plain_matches_pallas_make_run(label, spec):
    """K3's plain version (both passes and the update) against the JAX
    fully-fused step (``make_run``) in interpret mode on the same counter
    seed: over ``:fast`` both draw the fast normals (the pendulum's fast
    plant; the point mass's exact dynamics under fast sampling)."""
    jctrl, pctrl = make_pair(label, cfg=mppi_config(fully_fused=True), spec=spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    kernel_step, jpack, _ = jopt._build_fused_mppi(interpret=True, tile_k=TILE)
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                     jctrl._assemble_params())
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    U = popt.num_control_inputs
    rng = np.random.default_rng(8)
    s0 = states(label, rng, 1)[0]
    u_nom = rng.uniform(-0.4, 0.4, (H, U)).astype(np.float32)
    u_prev = np.full(U, 0.2, np.float32)
    seed = 7654321
    un_j, c_j = kernel_step(jnp.asarray(s0), jnp.asarray(u_nom),
                            jpack(jparams, jnp.asarray(u_prev)), jnp.array([seed], jnp.int32))
    model, pack = ode.rollout_model(popt)
    assert model.fast_math == spec.endswith("fast") == bool(jopt.predictor.predictor.fast_math)
    un_p, c_p = fused_mppi_step(model, torch.tensor(s0), torch.tensor(u_nom),
                                pack(params, torch.tensor(u_prev)),
                                torch.tensor([seed, 0], dtype=torch.int32), popt.interp.matrix,
                                popt.action_low, popt.action_high, popt.cc_weight, popt.R,
                                popt.NU, popt.LBD, popt.SQRTRHODTINV, K, TILE)
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), **K3_COST_TOL)
    np.testing.assert_allclose(un_p.numpy(), np.asarray(un_j), **UNOM_TOL)


# ---- one update of each optimizer, fed the JAX draws --------------------------------------
def set_mppi_state(jopt, popt, seed=0):
    rng = np.random.default_rng(seed)
    Hm, U = jopt.mpc_horizon, jopt.num_control_inputs
    u_nom = rng.uniform(-0.5, 0.5, (1, Hm, U)).astype(np.float32)
    u_prev = np.full(U, 0.2, np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_nom=jnp.asarray(u_nom), u_prev=jnp.asarray(u_prev))
    popt.opt_state = mppi_state_from_numpy(u_nom, u_prev, popt.opt_state.generator)


@pytest.mark.parametrize("label", sorted(PLANTS))
@pytest.mark.parametrize("semi_fused", [True, False])
def test_one_mppi_update_matches_jax(label, semi_fused):
    """Semi-fused (K2's plain version) and modular (K1's) MPPI fed the JAX
    step's noise."""
    jctrl, pctrl = make_pair(label, cfg=mppi_config(semi_fused=semi_fused))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused() == semi_fused
    set_mppi_state(jopt, popt)
    s = states(label, np.random.default_rng(9), 1)[0]
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                                 port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


@pytest.mark.parametrize("label", sorted(PLANTS))
def test_one_rpgd_update_matches_jax(label):
    """rpgd-tf (K7's and K1's plain versions) on a resample tick, fed the
    JAX draw."""
    jctrl, pctrl = make_pair(label, "rpgd-tf", rpgd_config(), jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert ode.can_use_grad(popt)
    rng = np.random.default_rng(0)
    shape = (jopt.num_rollouts, jopt.mpc_horizon, jopt.num_control_inputs)
    Q = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    m = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32)
    ages = rng.integers(0, 20, jopt.num_rollouts).astype(np.float32)
    u_prev = np.full(shape[2], 0.2, np.float32)
    from control_toolkit_tpu.ops import common as jcommon
    jopt.opt_state = jopt.opt_state._replace(
        Q=jnp.asarray(Q), adam=jcommon.AdamState(step=jnp.int32(4), m=jnp.asarray(m),
                                                 v=jnp.asarray(v)),
        trajectory_ages=jnp.asarray(ages), count=jnp.int32(0), u_prev=jnp.asarray(u_prev))
    popt.opt_state = rpgd_state_from_numpy(Q, m, v, 4, ages, 0, u_prev, popt.opt_state.generator)
    s = states(label, rng, 1)[0]
    draw = torch.as_tensor(jax_rpgd_draw(jopt))
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None],
                                 params_from_numpy(jax_params_numpy(jctrl), CPU), draw)
    js, jlog = jopt.opt_state, jopt.logging_values
    np.testing.assert_allclose(diag["J_logged"].numpy(), jlog["J_logged"], **COST_TOL)
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


CONTIGUITY_PATHS = {  # optimizer: its config's extra keys
    "mppi": {}, "mppi-modular": {"semi_fused": False}, "mppi-fused": {"fully_fused": True},
    "rpgd-tf": {}, "gradient-tf": {"gradient_steps": 2}, "cem-tf": {"cem_best_k": 8},
    "icem-tf": {"cem_best_k": 8}, "random-action-tf": {}, "cem-gmm-tf": {"cem_best_k": 8},
    "cma-es-tf": {}, "cem-naive-grad-tf": {"cem_best_k": 8},
    "cem-grad-bharadhwaj-tf": {"cem_best_k": 4, "warmup": False},
}


@pytest.mark.parametrize("path", sorted(CONTIGUITY_PATHS))
def test_two_input_paths_give_the_kernels_contiguous_operands(path, monkeypatch):
    """Over the point mass's two inputs every optimizer hands its kernels
    contiguous operands, which the CUDA wrappers require (an einsum lays
    U > 1 controls out input-major: ``Interpolator.interpolate``); on the
    CPU each wrapper's ``kernels.on_cpu`` sees the same operands."""
    seen = []
    on_cpu = kernels.on_cpu

    def checked(*tensors):
        seen.append(all(t.is_contiguous() for t in tensors))
        return on_cpu(*tensors)

    monkeypatch.setattr(kernels, "on_cpu", checked)
    name = path.split("-modular")[0].split("-fused")[0]
    base = rpgd_config(num_rollouts=64, mpc_horizon=10) if name in ("rpgd-tf", "gradient-tf") \
        else mppi_config(num_rollouts=64, mpc_horizon=10)
    ctrl = port_ctrl("pointmass", name, {**base, **CONTIGUITY_PATHS[path]})
    if path == "mppi-fused":
        ctrl.optimizer.fused_tile_k = 64
        ctrl.optimizer._build()
        assert ctrl.optimizer._can_fully_fuse()
    s = states("pointmass", np.random.default_rng(0), 1)[0]
    for _ in range(2):
        s = s + 0.01 * ctrl.step(s).sum()
    assert seen and all(seen)


# ---- the gates -----------------------------------------------------------------------------
def small(**extra):
    return mppi_config(num_rollouts=32, mpc_horizon=8, **extra)


def small_rpgd(**extra):
    return rpgd_config(num_rollouts=32, mpc_horizon=8, **extra)


def gp_params(S, U, M=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"Z": rng.standard_normal((M, S + U)).astype(np.float32),
            "lengthscales": np.ones(S + U, np.float32), "variance": np.float32(1.0),
            "alpha": (0.01 * rng.standard_normal((M, S))).astype(np.float32),
            "in_mean": np.zeros(S + U, np.float32), "in_std": np.ones(S + U, np.float32),
            "out_mean": np.zeros(S, np.float32), "out_std": np.ones(S, np.float32)}


def value_net(S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w0": 0.3 * torch.randn(S, 8, generator=g), "b0": torch.zeros(8),
            "w1": 0.3 * torch.randn(8, 1, generator=g), "b1": torch.zeros(1)}


def valued(label, optimizer, cfg):
    ctrl = port_ctrl(label, optimizer, cfg)
    attach_value_terminal(ctrl, value_net(DIMS[PLANTS[label][0]][0]), 2.0)
    return ctrl


def fused_cem(label):
    """Fused CEM at a tile that divides K (K5's gate, as the JAX one)."""
    ctrl = port_ctrl(label, "cem-tf", {**small(), "fully_fused": True, "cem_outer_it": 1,
                                       "cem_best_k": 8})
    ctrl.optimizer.fused_tile_k = 32
    ctrl.optimizer._build()
    return ctrl


def fleet(label, optimizer, cfg, **kw):
    return port_ctrl(label, optimizer, cfg, cls=BatchedMPCController, num_slots=2, **kw)


# label of the path: (the kernel form it would launch, a function that builds it)
REFUSED = {
    "fused_cem": ("K5", lambda lb: fused_cem(lb)),
    "mppi_fleet": ("K4", lambda lb: fleet(lb, "mppi", small())),
    "fused_cem_fleet": ("K6", lambda lb: fleet(lb, "cem-tf", {**small(), "fully_fused": True,
                                                               "warmup": False,
                                                               "cem_outer_it": 1,
                                                               "cem_best_k": 8})),
    "modular_cem_fleet": ("K1's session-row form",
                          lambda lb: port_ctrl(lb, "cem-tf", {**small(), "cem_best_k": 8})
                          .optimizer._make_batched_cem_step(2)),
    "rpgd_fleet": ("K7's session-row form", lambda lb: fleet(lb, "rpgd-tf", small_rpgd())),
    "valued_mppi": ("K2's emit_terminal form", lambda lb: valued(lb, "mppi", small())),
    "valued_modular_mppi": ("K1's emit_terminal form",
                            lambda lb: valued(lb, "mppi", small(semi_fused=False))),
    "valued_rpgd": ("K7's value_spec form", lambda lb: valued(lb, "rpgd-tf", small_rpgd())),
    "mlp": ("K11", lambda lb: port_ctrl(lb, "mppi", small(), "neural:mlp-16-16")),
    "mlp_rpgd": ("K8", lambda lb: port_ctrl(lb, "rpgd-tf", small_rpgd(), "neural:mlp-16-16")),
    "gru": ("K13", lambda lb: port_ctrl(lb, "mppi", small(), "neural:GRU-8H1")),
    "gp": ("K14", lambda lb: port_ctrl(
        lb, "mppi", small(), "gp",
        predictor_config={"params": gp_params(*DIMS[PLANTS[lb][0]])})),
    "gp_rpgd": ("K10", lambda lb: port_ctrl(
        lb, "rpgd-tf", small_rpgd(), "gp",
        predictor_config={"params": gp_params(*DIMS[PLANTS[lb][0]])})),
    "ensemble": ("K11's member-block form",
                 lambda lb: port_ctrl(lb, "mppi", small(), "ensemble:mlp-8-8:2")),
    "ensemble_rpgd": ("K8's member-block form",
                      lambda lb: port_ctrl(lb, "rpgd-tf", small_rpgd(), "ensemble:mlp-8-8:2")),
    "residual": ("K12", lambda lb: port_ctrl(lb, "mppi", small(), "ODE+res")),
    "residual_rpgd": ("K9", lambda lb: port_ctrl(lb, "rpgd-tf", small_rpgd(), "ODE+res")),
}


@pytest.mark.parametrize("path", sorted(REFUSED))
@pytest.mark.parametrize("label", ["pendulum", "pointmass_obstacles"])
def test_paths_without_an_instance_raise_naming_kernel_and_plant(path, label):
    """Every path on which the JAX package would launch a kernel that has no
    instance of these plants raises NotImplementedError naming the kernel
    and the plant, at configure: none takes the scan or another kernel."""
    kernel, build = REFUSED[path]
    plant = PLANTS[label][2]
    with pytest.raises(NotImplementedError) as err:
        build(label)
    msg = str(err.value)
    assert kernel in msg and repr(plant) in msg, msg


def test_paths_without_a_device_plant_take_the_scan():
    """A cost that no device plant evaluates runs the fused scan in both
    packages: pointmass/trajectory (array attributes, its own
    _get_stage_cost) and a user's subclass of a device cost; an MPPI step
    over the trajectory cost matches the JAX package's."""
    class MyPendulumCost(PendulumQuadraticCost):
        pass

    ctrl = port_ctrl("pendulum", cfg=small())
    ctrl.cost_function.cost_function = MyPendulumCost()
    opt = ctrl.optimizer
    assert not ode.device_cost(opt) and opt._make_cost_only() == opt._fused_cost
    cfg = mppi_config(semi_fused=False)
    env, _, _, attrs = PLANTS["pointmass"]
    jctrl = JaxMPC(env, limits(env), dict(attrs), config={
        "optimizer": "mppi", "controller_logging": False,
        "cost_function_specification": "trajectory"})
    jctrl.configure(optimizer_name="mppi", optimizer_config=cfg)
    pctrl = MPCController(env, limits(env), dict(attrs), config={
        "device": "cpu", "optimizer": "mppi", "controller_logging": False,
        "cost_function_specification": "trajectory"})
    pctrl.configure(optimizer_name="mppi", optimizer_config=cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert not ode.device_cost(popt) and not popt._uses_semi_fused()
    assert popt._make_cost_only() is None or popt._make_cost_only() == popt._fused_cost
    set_mppi_state(jopt, popt)
    s = states("pointmass", np.random.default_rng(3), 1)[0]
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    u, _, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None],
                             params_from_numpy(jax_params_numpy(jctrl), CPU),
                             port_noise(popt, delta))
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


@pytest.mark.parametrize("label", ["pendulum", "pointmass"])
def test_fully_fused_reaches_k3(label):
    """``fully_fused`` over the new plants takes K3 (the JAX gate admits
    them too), not the semi-fused K2."""
    ctrl = port_ctrl(label, cfg=mppi_config(fully_fused=True), spec="ODE:rk4:1:fast")
    opt = ctrl.optimizer
    opt.fused_tile_k = TILE
    opt._build()
    assert opt._can_fully_fuse() and not opt._uses_semi_fused()
    assert opt._noise_shape is None  # K3's counter seed, not K2's noise
    u = ctrl.step(states(label, np.random.default_rng(1), 1)[0])
    assert np.all(np.isfinite(u))


def test_unknown_plants_and_forms_are_refused_before_a_launch():
    """The record refuses a plant that a form does not carry, and every
    wrapper consults it before any launch (the C entries return
    cudaErrorInvalidValue for them too)."""
    from control_toolkit_tpu_torch.ops import cost_rollout as k1_module

    with pytest.raises(NotImplementedError, match="K1's emit_terminal form over the 'acrobot'"):
        kernels.require("K1's emit_terminal form", "acrobot")
    with pytest.raises(NotImplementedError, match="K5 over the 'quadrotor2d'"):
        kernels.require("K5", "quadrotor2d")
    for kernel in ("K1", "K2", "K3", "K7"):
        assert set(kernels.KERNEL_PLANTS[kernel]) == set(kernels.PLANT_IDS)
    _, pctrl, _, params = pair("acrobot")
    model, pack = ode.rollout_model(pctrl.optimizer)
    s0, Q = torch.zeros(8, 4), torch.zeros(8, 3, 1)
    with pytest.raises(NotImplementedError, match="K1's emit_terminal form"):
        k1_module._launch("cost_rollout_emit", model, s0, Q, pack(params, torch.zeros(1)), 8,
                          torch.empty(8, 4))
    with pytest.raises(ValueError, match="fast_sampling"):
        kernels.RolloutModel(**{**{f: getattr(model, f) for f in (
            "plant", "param_keys", "derivs", "stage", "terminal", "integrator", "dt",
            "intermediate_steps", "max_cost")}, "fast_sampling": True})


# ---- on a card: each new instance against its plain version --------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K7"])
@pytest.mark.parametrize("plant", ["pendulum", "pendulum_fast", "acrobot", "acrobot_fast",
                                   "pointmass", "pointmass_obstacles"])
def test_cuda_plant_instances_match_plain_versions(cuda_device, kernel, plant):
    """Each plant's instance of K1, K2, K3's pass 1 and K7 against its plain
    version on the same card tensors, at ragged K (not a multiple of a
    block) and, for the point mass, a horizon that is not a multiple of
    its 32-step controls-ahead chunk (test_torch_kernels.py's tolerance)."""
    from control_toolkit_tpu_torch.ops.fused_mppi import fused_mppi_costs, fused_mppi_costs_plain
    from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
    from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost_plain

    label = "pointmass_obstacles" if plant == "pointmass_obstacles" else plant.split("_")[0]
    spec = "ODE:rk4:1:fast" if plant.endswith("_fast") else "ODE"
    ctrl = port_ctrl(label, spec=spec)
    model, pack = ode.rollout_model(ctrl.optimizer)
    assert model.plant == plant
    dev = cuda_device
    S, U = kernels.PLANT_DIMS[plant]
    Kc, Hc = 700, 45
    gen = torch.Generator(device=dev).manual_seed(0)
    pvec = pack(ctrl._assemble_params(), torch.full((U,), 0.1)).to(dev)
    s0 = torch.as_tensor(states(label, np.random.default_rng(0), Kc), device=dev)
    Q = torch.clamp(0.4 * torch.randn(Kc, Hc, U, generator=gen, device=dev), -1.0, 1.0)
    tol = dict(rtol=1e-4, atol=1e-3)
    if kernel == "K1":
        torch.testing.assert_close(cost_rollout(model, s0, Q, pvec),
                                   cost_rollout_plain(model, s0, Q, pvec), **tol)
        return
    if kernel == "K7":
        got, ref = grad_cost_rollout(model, s0, Q, pvec), grad_cost_rollout_plain(model, s0, Q, pvec)
        torch.testing.assert_close(got[0], ref[0], **tol)
        assert float((got[1] - ref[1]).abs().max()) <= 2e-5 * float(ref[1].abs().max()) + 1e-6
        return
    W = torch.as_tensor(interpolation_matrix(Hc, 10), device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(Hc, U, generator=gen, device=dev), -1.0, 1.0)
    lim = torch.ones(U, device=dev)
    if kernel == "K2":
        eps = 0.2 * torch.randn(W.shape[0], U, Kc, generator=gen, device=dev)
        args = (model, s0[0].contiguous(), u_nom, pvec, eps, W, -lim, lim, 1.0, 1.0, 1000.0)
        torch.testing.assert_close(mppi_cost(*args), mppi_cost_plain(*args), **tol)
        return
    Kf = 1024  # K3 tiles K
    seed2 = torch.tensor([99, 0], dtype=torch.int32, device=dev)
    args = (model, s0[0].contiguous(), u_nom, pvec, seed2, W, -lim, lim, 1.0, 1.0, 1000.0, 0.3,
            Kf, 128)
    torch.testing.assert_close(fused_mppi_costs(*args), fused_mppi_costs_plain(*args), **tol)
