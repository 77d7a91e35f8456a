"""The fleets and fully-fused CEM over the pendulum, acrobot, point-mass,
quadrotor, car and arm plants (plant ids 2-17) against the JAX package:
K4, K5, K6 and the session-row forms of K1 and K7, and the steps that run
them.

Each form's plain version is held, for every plant, to the JAX kernel the
JAX package builds for it, in interpret mode (B=2 sessions, H=8, JAX tile
128 or 64): K5 to ``_build_fused_cem`` (one tile of 128), K6 to
``build_fused_cem_cols``, K4 to ``make_run.cols`` (the noise through
``eps_from_tiles``), K1's and K7's session-row forms to
``build_cost_rollout_kernel`` and ``build_grad_cost_rollout_kernel`` with
``slot_keys`` (the batched CEM and gradient steps' kernels).  The sessions
differ in state, previous control, targets and one dynamics constant of
the plant (``SLOT_DYN``, the fleets' ``per_slot_dyn``).  One update of each
path (the MPPI, mppi-var, fused-CEM, rpgd-tf and gradient-tf fleets, the
modular batched CEM step and single-session fused CEM) is held to the JAX
package's step over the pendulum, the point mass under obstacles, the 3-D
quadrotor (S=12, U=4) and car/obstacles, fed the JAX draws.  A ``:fast``
point mass keeps its exact dynamics under the fast normals in K5 and K6,
their counters bit for bit JAX's.  ``per_slot_dyn`` takes each plant's
constants; arm2's mirrored ``l1`` moves the dynamics alone, the cost's
``l1`` staying the shared one, in both packages.

Tolerances, each with its reason: the costs to tests/test_torch_plants.py's
COST_TOL (float32 sums over 8 rk4 steps, the normals an ulp of log or cos
apart) and dQ to its GRAD_TOL; the regenerated controls to NORMAL_ATOL;
the steps' plans, controls and distributions to the bounds of the cartpole
tests they follow (test_torch_fleet.py, test_torch_fleet_cem.py,
test_torch_fleet_grad.py, test_torch_mppi_var.py, test_torch_cem.py).  On a
machine with a card, every plant's instance of each form is held to its
plain version (``-m cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops.common import AdamState as JaxAdamState
from control_toolkit_tpu.ops.pallas_cem import build_fused_cem_cols
from control_toolkit_tpu.ops.pallas_grad import build_grad_cost_rollout_kernel
from control_toolkit_tpu.ops.pallas_rollout import build_cost_rollout_kernel
from control_toolkit_tpu.optimizers.base import make_slot_packer as jax_slot_packer
from control_toolkit_tpu.optimizers.cem import CEMState as JaxCEMState
from control_toolkit_tpu.optimizers.gradient import GradientState as JaxGradientState
from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
from control_toolkit_tpu.optimizers.mppi_var import MPPIVarState as JaxVarState
from control_toolkit_tpu.optimizers.rpgd import RPGDState as JaxRPGDState
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout, cost_rollout_cols, cost_rollout_cols_emit, cost_rollout_cols_emit_plain,
    cost_rollout_cols_plain,
)
from control_toolkit_tpu_torch.ops.counter_prng import FNV, MASK
from control_toolkit_tpu_torch.ops.fused_cem import (
    cem_counters, fused_cem_costs, fused_cem_costs_plain, regen_controls,
)
from control_toolkit_tpu_torch.ops.fused_cem_cols import (
    cols_counters, fused_cem_cols, fused_cem_cols_plain, regen_cols,
)
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout_cols, grad_cost_rollout_cols_plain, grad_cost_rollout_cols_value,
)
from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
from control_toolkit_tpu_torch.ops.mppi_cost_cols import (
    eps_from_tiles, mppi_cost_cols, mppi_cost_cols_emit, mppi_cost_cols_emit_plain,
    mppi_cost_cols_plain,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.optimizers.mppi import MPPIState
from control_toolkit_tpu_torch.optimizers.mppi_var import MPPIVarState
from control_toolkit_tpu_torch.utils.convert import (
    gradient_slot_states_from_numpy, params_from_numpy, rpgd_slot_states_from_numpy,
)
from test_torch_fleet import UNOM_TOL as FLEET_UNOM_TOL
from test_torch_fleet_grad import ADAM_STEPS, CEM_REFIT_ATOL, assert_states_match
from test_torch_cem import use_fused
from test_torch_fleet_cem import STEP_ATOL
from test_torch_grad import GRAD_TOL
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, COST_TOL, UNOM_TOL, jax_params_numpy
from test_torch_mppi_var import SIGMA_TOL, var_config
from test_torch_plants import (
    DIMS, PLANTS, controls, label_of, limits, make_pair, mppi_config, port_ctrl, states,
)
from test_torch_prng import NORMAL_ATOL

B, KC, HF, TILE, ROWS = 2, 64, 8, 128, 8
LABELS = sorted(PLANTS)
# The fleet updates' plants: a one-input plant, the obstacle penalty over
# two inputs, the 12-state four-rotor plant and the car under obstacles.
FLEET_LABELS = ("pendulum", "pointmass_obstacles", "quadrotor3d", "car_obstacles")
# The dynamics constant each environment's fleet plans per slot.
SLOT_DYN = {"pendulum": "L", "acrobot": "m2", "pointmass": "mass", "quadrotor2d": "m",
            "quadrotor3d": "m", "car": "wheelbase", "arm2": "l1"}
# How much further from float64 the card's arm2 dQ may lie than the float32
# plain version's (chip_smoke.py GP_F64_FACTOR).
F64_FACTOR = 2.0
# Slots 0 and 1 of the rpgd-tf fleet update: one on its resample tick.
RPGD_COUNTS = (10, 7)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def env_of(label):
    return PLANTS[label][0]


def cem_config(K=KC, **extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": HF, "num_rollouts": K,
           "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
           "cem_best_k": 8, "warmup": False}
    cfg.update(extra)
    return cfg


def grad_config(name, **extra):
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": HF, "num_rollouts": KC // 2,
           "learning_rate": 0.05, "gradmax_clip": 5, "warmup": False}
    if name == "gradient-tf":
        cfg["gradient_steps"] = 2
    else:
        cfg.update(outer_its=2, opt_keep_k_ratio=0.25, resamp_per=10,
                   period_interpolation_inducing_points=4, SAMPLING_DISTRIBUTION="uniform",
                   sample_stdev=0.5)
    cfg.update(extra)
    return cfg


_PAIRS = {}


def pair(label, optimizer="mppi", cfg=None, spec="ODE"):
    """The JAX and port ``mpc`` controllers of one configuration (built once
    a module) with the JAX params in both forms."""
    key = (label, optimizer, tuple(sorted((cfg or {}).items())), spec)
    if key not in _PAIRS:
        jctrl, pctrl = make_pair(label, optimizer, cfg or mppi_config(num_rollouts=KC,
                                                                       mpc_horizon=HF), spec)
        jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                         jctrl._assemble_params())
        _PAIRS[key] = (jctrl, pctrl, jparams,
                       params_from_numpy(jax_params_numpy(jctrl), CPU))
    return _PAIRS[key]


def sessions(label, jparams, seed, n=B):
    """Per-session operands made with numpy: states ``s [n, 1, S]``,
    previous controls, targets moved by up to 0.2, and the plant's slot
    constant over 0.9-1.1 of its default."""
    env = env_of(label)
    U = DIMS[env][1]
    rng = np.random.default_rng(seed)
    key = SLOT_DYN[env]
    attrs = {k: (np.full(n, v, np.float32)
                 + (rng.uniform(-0.2, 0.2, n).astype(np.float32) if k.startswith("target")
                    else 0.0)).astype(np.float32)
             for k, v in PLANTS[label][3].items()}
    return {"s": states(label, rng, n)[:, None], "u_prev": controls(env, rng, (n, U)),
            "slot": (float(jparams["dyn"][key]) * np.linspace(0.9, 1.1, n)).astype(np.float32),
            "attrs": attrs, "key": key}


def jax_args(x, jparams):
    return (jnp.asarray(x["s"]), dict(jparams["dyn"], **{x["key"]: jnp.asarray(x["slot"])}),
            jparams["cost"], {k: jnp.asarray(v) for k, v in x["attrs"].items()})


def port_args(x, params):
    return (torch.tensor(x["s"]), dict(params["dyn"], **{x["key"]: torch.tensor(x["slot"])}),
            params["cost"], {k: torch.tensor(v) for k, v in x["attrs"].items()})


def port_rows(popt, x, params, model=None):
    """The sessions' packed rows ``pvec_b [n, N]`` the port's fleets build."""
    model = model or ode.rollout_model(popt)[0]
    _, slot_keys = split_slot_keys(model.param_keys, (x["key"],))
    _, dyn, cost, attrs = port_args(x, params)
    cf = popt.cost_function.cost_function
    return make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, len(x["slot"]), CPU)(
        torch.tensor(x["u_prev"]), dyn, cost, attrs)


def jax_slot_keys(param_keys, key):
    return [k for k in param_keys if k.startswith(("a_", "__u_prev_")) or k == f"d_{key}"]


def expand_cols(vals, n, K, tile=TILE):
    """``[n, m]`` per-session rows as the JAX column kernels' ``[T, m, C]``."""
    cps, T, C = K // ROWS, (n * K) // tile, tile // ROWS
    return jnp.repeat(vals, cps, axis=0).reshape(T, C, vals.shape[1]).transpose(0, 2, 1)


def cols_order(costs2d, n, K):
    """The JAX column kernels' ``costs2d [8, n*K/8]`` as ``[n, K]``."""
    cps = K // ROWS
    return np.asarray(costs2d).reshape(ROWS, n, cps).transpose(1, 0, 2).reshape(n, K)


def lim(label):
    return tuple(torch.as_tensor(v) for v in limits(env_of(label)))


# ---- each form's plain version against the JAX kernel ----------------------------------------
@pytest.mark.parametrize("label", LABELS)
def test_k5_plain_matches_pallas_interpret(label):
    """K5's plain version against ``_build_fused_cem`` (one tile of 128) on
    the same seed and tile offset, and the elite rows' regeneration against
    JAX's ``regen_controls``."""
    jctrl, pctrl, jparams, params = pair(label, "cem-tf", cem_config(K=TILE, fully_fused=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    run, regen, jpack = jopt._build_fused_cem(interpret=True, tile_k=TILE)
    env = env_of(label)
    U = DIMS[env][1]
    rng = np.random.default_rng(11)
    s0 = states(label, rng, 1)[0]
    mue, u_prev = controls(env, rng, (HF, U), 0.6), controls(env, rng, (U,))
    std = np.full((HF, U), 0.4, np.float32)
    seed2 = np.array([2**31 - 5, 3], np.int32)
    ref = np.asarray(run(jnp.asarray(s0), jnp.asarray(mue), jnp.asarray(std),
                         jpack(jparams, jnp.asarray(u_prev)), jnp.asarray(seed2))).reshape(-1)
    model, pack = ode.rollout_model(popt)
    lo, hi = lim(label)
    got = fused_cem_costs(model, torch.tensor(s0), torch.tensor(mue), torch.tensor(std),
                          pack(params, torch.tensor(u_prev)), torch.tensor(seed2), lo, hi,
                          TILE, TILE).numpy()
    np.testing.assert_allclose(got, ref, **COST_TOL)
    idx = np.random.default_rng(1).permutation(TILE)[:16]
    q = regen_controls(torch.tensor(seed2), torch.tensor(idx), torch.tensor(mue),
                       torch.tensor(std), lo, hi, TILE, TILE, fast=model.fast_math).numpy()
    q_ref = np.asarray(regen(jnp.asarray(seed2), jnp.asarray(idx), jnp.asarray(mue),
                             jnp.asarray(std), TILE))
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=NORMAL_ATOL)


def jax_k6(jopt, label, n, fast=False):
    param_keys, _, derivs, stage_soa, terminal_soa, pred = jopt._soa_bindings()
    slot_keys = jax_slot_keys(param_keys, SLOT_DYN[env_of(label)])
    S, U = DIMS[env_of(label)]
    make_run_cols, regen = build_fused_cem_cols(
        derivs, stage_soa, terminal_soa, num_states=S, num_controls=U, horizon=HF,
        param_keys=param_keys, slot_keys=slot_keys, action_low=jopt.action_low,
        action_high=jopt.action_high, k_per_session=KC, integrator=pred.integrator,
        intermediate_steps=pred.intermediate_steps, tile_k=TILE, interpret=True,
        fast_sampling=fast)
    return make_run_cols(n * KC, pred.dt), regen, param_keys, slot_keys


def k6_case(label, spec="ODE", seed=3):
    """K6 over ``label``: the JAX kernel's costs [B, K], the port's plain
    version's, and the operands."""
    jctrl, pctrl, jparams, params = pair(label, "cem-tf", cem_config(fully_fused=True), spec)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, _ = ode.rollout_model(popt)
    run, regen, param_keys, slot_keys = jax_k6(jopt, label, B, model.fast_math)
    x = sessions(label, jparams, seed)
    env = env_of(label)
    U = DIMS[env][1]
    rng = np.random.default_rng(seed + 1)
    mue = controls(env, rng, (B, HF, U), 0.6)
    std = rng.uniform(0.2, 0.6, (B, HF, U)).astype(np.float32)
    seed_b = np.array([1234, 2**31 - 2], np.int32)
    defaults = jopt.cost_function.cost_function.attr_defaults
    slot_vals = {f"d_{x['key']}": x["slot"],
                 **{f"a_{k}": np.full(B, v, np.float32) for k, v in defaults.items()},
                 **{f"a_{k}": v for k, v in x["attrs"].items()},
                 **{f"__u_prev_{j}": x["u_prev"][:, j] for j in range(U)}}
    shared = [k for k in param_keys if k not in slot_keys]
    pvec = jnp.stack([jnp.asarray(jparams["dyn"][k[2:]] if k.startswith("d_")
                                  else jparams["cost"][k[2:]], jnp.float32) for k in shared])
    rows = jnp.stack([jnp.asarray(slot_vals[k], jnp.float32) for k in slot_keys], axis=1)
    cps, T, C = KC // ROWS, (B * KC) // TILE, TILE // ROWS
    seedcw = jnp.stack([jnp.repeat(jnp.asarray(seed_b), cps),
                        jnp.tile(jnp.arange(cps, dtype=jnp.int32), B)],
                       axis=1).reshape(T, C, 2).transpose(0, 2, 1)
    ref = cols_order(run(pvec, expand_cols(jnp.asarray(x["s"][:, 0]), B, KC),
                         expand_cols(jnp.asarray(mue.reshape(B, HF * U)), B, KC),
                         expand_cols(jnp.asarray(std.reshape(B, HF * U)), B, KC),
                         expand_cols(rows, B, KC), seedcw), B, KC)
    lo, hi = lim(label)
    args = (model, torch.tensor(x["s"][:, 0]), torch.tensor(mue), torch.tensor(std),
            port_rows(popt, x, params), torch.tensor(seed_b), lo, hi, KC)
    return ref, fused_cem_cols(*args), args, regen


@pytest.mark.parametrize("label", LABELS)
def test_k6_plain_matches_pallas_cols(label):
    """K6's plain version against ``build_fused_cem_cols`` with per-session
    states, distributions, rows and seeds; the elite rows' regeneration
    against JAX's ``regen_cols``."""
    ref, got, args, regen = k6_case(label)
    assert got.shape == (B, KC)
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)
    model, _, mue, std, _, seed_b, lo, hi, _ = args
    idx = np.stack([np.random.default_rng(b).permutation(KC)[:8] for b in range(B)])
    q = regen_cols(seed_b, torch.tensor(idx), mue, std, lo, hi, KC, fast=model.fast_math).numpy()
    for b in range(B):
        q_ref = np.asarray(regen(jnp.asarray(seed_b[b].numpy()), jnp.asarray(idx[b]),
                                 jnp.asarray(mue[b].numpy()), jnp.asarray(std[b].numpy())))
        np.testing.assert_allclose(q[b], q_ref, rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("label", LABELS)
def test_k4_plain_matches_pallas_cols(label):
    """K4's plain version against ``make_run.cols`` with the plant's slot
    constant among the per-session rows, fed the same noise."""
    jctrl, pctrl, jparams, params = pair(label)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 5)
    key, env = x["key"], env_of(label)
    U = DIMS[env][1]
    _, _, make_run = jopt._build_fused_mppi(build_step=False, interpret=True, tile_k=TILE,
                                            slot_extra_keys=(f"d_{key}",))
    cf = jopt.cost_function.cost_function
    pvec, rows = jax_slot_packer(make_run.shared_keys, make_run.slot_keys, cf.attr_defaults,
                                 B)(jnp.asarray(x["u_prev"]), *jax_args(x, jparams)[1:])
    P = jopt.interp.number_of_interpolation_inducing_points
    rng = np.random.default_rng(6)
    u_nom = controls(env, rng, (B, HF, U), 0.4)
    T, C = (B * KC) // TILE, TILE // ROWS
    eps = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    ref = cols_order(make_run.cols(B * KC)(
        pvec, expand_cols(jnp.asarray(x["s"][:, 0]), B, KC),
        expand_cols(jnp.asarray(u_nom.transpose(0, 2, 1).reshape(B, -1)), B, KC),
        expand_cols(rows, B, KC), jnp.asarray(eps)), B, KC)
    model, _ = ode.rollout_model(popt)
    lo, hi = lim(label)
    got = mppi_cost_cols(model, torch.tensor(x["s"][:, 0]), torch.tensor(u_nom),
                         port_rows(popt, x, params), eps_from_tiles(torch.tensor(eps), B),
                         popt.interp.matrix, lo, hi, popt.cc_weight, popt.R, popt.NU)
    assert got.shape == (B, KC)
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)


def rows_case(label, ks, seed):
    """The session-row forms' operands over ``label``: the JAX kernels'
    ``(s0, Q, pvec, pslot)`` and the port's ``(model, s0, Q, pvec_b)``,
    B sessions of ``ks`` rollouts each."""
    jctrl, pctrl, jparams, params = pair(label)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, seed)
    env = env_of(label)
    rng = np.random.default_rng(seed + 1)
    S, U = DIMS[env]
    s0 = np.repeat(x["s"][:, 0], ks, axis=0)
    Q = controls(env, rng, (B * ks, HF, U), 0.8)
    param_keys, _, derivs, stage_soa, terminal_soa, pred = jopt._soa_bindings()
    slot_keys = jax_slot_keys(param_keys, x["key"])
    shared = [k for k in param_keys if k not in slot_keys]
    cf = jopt.cost_function.cost_function
    pvec, pslot = jax_slot_packer(shared, slot_keys, cf.attr_defaults, B, ks)(
        jnp.asarray(x["u_prev"]), *jax_args(x, jparams)[1:])
    kargs = dict(num_states=S, num_controls=U, horizon=HF, dt=pred.dt, param_keys=param_keys,
                 integrator=pred.integrator, intermediate_steps=pred.intermediate_steps,
                 tile_k=B * ks, interpret=True, slot_keys=slot_keys)
    jax_ops = (jnp.asarray(s0), jnp.asarray(Q), pvec, pslot)
    model, _ = ode.rollout_model(popt)
    port = (model, torch.tensor(s0), torch.tensor(Q), port_rows(popt, x, params))
    return (derivs, stage_soa, terminal_soa, kargs), jax_ops, port


@pytest.mark.parametrize("label", LABELS)
def test_k1_rows_plain_matches_pallas_slot_kernel(label):
    """K1's session-row form against the JAX cost kernel's ``slot_keys`` form
    (the batched CEM step's and the gradient fleets' scoring kernel), each
    session under its own row."""
    (derivs, stage, terminal, kargs), jax_ops, port = rows_case(label, KC, 7)
    ref = np.asarray(build_cost_rollout_kernel(derivs, stage, terminal, **kargs)(*jax_ops))
    got = cost_rollout_cols(*port)
    assert got.shape == (B, KC)
    np.testing.assert_allclose(got.numpy().reshape(-1), ref, **COST_TOL)


@pytest.mark.parametrize("label", LABELS)
def test_k7_rows_plain_matches_pallas_slot_kernel(label):
    """K7's session-row form against the JAX gradient kernel's ``slot_keys``
    form (the rpgd-tf and gradient-tf fleets' kernel): costs and dQ.  The
    3-D quadrotor's jax.vjp in interpret mode is the slow case: 16 rollouts
    a session there."""
    ks = 16 if label == "quadrotor3d" else KC // 2
    (derivs, stage, terminal, kargs), jax_ops, port = rows_case(label, ks, 8)
    ref_cost, ref_dq = map(np.asarray, build_grad_cost_rollout_kernel(
        derivs, stage, terminal, **kargs)(*jax_ops))
    cost, dQ = grad_cost_rollout_cols(*port)
    assert cost.shape == (B, ks) and dQ.shape == port[2].shape
    np.testing.assert_allclose(cost.numpy().reshape(-1), ref_cost, **COST_TOL)
    np.testing.assert_allclose(dQ.numpy(), ref_dq, **GRAD_TOL)


# ---- one update of each path against the JAX step --------------------------------------------
def slot_keys_jax(n=B, seed=0):
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(n)])


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_mppi_fleet_update_matches_jax(label):
    """One batched semi-fused MPPI update (K4) fed the JAX noise: costs and
    the new plans."""
    jctrl, pctrl, jparams, params = pair(label)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 11)
    env = env_of(label)
    U = DIMS[env][1]
    psd = (x["key"],)
    _, jupdate = jopt._make_batched_semi_fused_step(B, interpret=True, tile_k=TILE,
                                                    per_slot_dyn=psd)
    _, update = popt._make_batched_semi_fused_step(B, per_slot_dyn=psd)
    rng = np.random.default_rng(12)
    u_nom = controls(env, rng, (B, 1, HF, U), 0.4)
    P = jopt.interp.number_of_interpolation_inducing_points
    T, C = (B * KC) // TILE, TILE // ROWS
    eps = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    jstates = JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32), u_nom=jnp.asarray(u_nom),
                           u_prev=jnp.asarray(x["u_prev"]))
    u_ref, c_ref = jupdate(jstates, *jax_args(x, jparams), jnp.asarray(eps))
    states_ = MPPIState(generator=(None,) * B, u_nom=torch.tensor(u_nom),
                        u_prev=torch.tensor(x["u_prev"]))
    u_got, costs = update(states_, *port_args(x, params), eps_from_tiles(torch.tensor(eps), B))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **COST_TOL)
    np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref), **FLEET_UNOM_TOL)


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_var_fleet_update_matches_jax(label):
    """One batched mppi-var update (K4) fed JAX's per-slot raw draws: costs,
    plans, controls and each session's adapted sigma."""
    cfg = var_config(KC, HF)
    jctrl, pctrl, jparams, params = pair(label, "mppi-var-tf", cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 13)
    env = env_of(label)
    U = DIMS[env][1]
    psd = (x["key"],)
    rng = np.random.default_rng(14)
    u_nom = controls(env, rng, (B, 1, HF, U), 0.4)
    stdev = rng.uniform(0.3, 1.2, (B, U)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jstep = jopt._make_batched_var_step(B, interpret=True, tile_k=TILE, per_slot_dyn=psd)
    u_j, st_j, c_j = jstep(JaxVarState(key=keys, u_nom=jnp.asarray(u_nom),
                                       u_prev=jnp.asarray(x["u_prev"]),
                                       stdev=jnp.asarray(stdev)), *jax_args(x, jparams))
    P, cps = jopt.interp.number_of_interpolation_inducing_points, KC // ROWS
    sample = jax.vmap(lambda k: jax.random.split(k))(keys)[:, 1]
    raw = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (U, P * ROWS, cps), jnp.float32))(
        sample))
    raw = np.ascontiguousarray(raw.reshape(B, U, P, ROWS, cps).transpose(0, 2, 1, 3, 4)
                               .reshape(B, P, U, KC))
    _, update = popt._make_batched_var_step(B, per_slot_dyn=psd)
    u, st, costs = update(MPPIVarState((None,) * B, torch.tensor(u_nom),
                                       torch.tensor(x["u_prev"]), torch.tensor(stdev)),
                          *port_args(x, params), torch.tensor(raw))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_j), **COST_TOL)
    np.testing.assert_allclose(st.u_nom.numpy(), np.asarray(st_j.u_nom), **FLEET_UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **FLEET_UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **SIGMA_TOL)


def cem_slot_states(x, jparams, seed):
    env = env_of(x["label"])
    U = DIMS[env][1]
    rng = np.random.default_rng(seed)
    mue = controls(env, rng, (B, 1, HF, U), 0.4)
    std = rng.uniform(0.2, 0.6, (B, 1, HF, U)).astype(np.float32)
    keys = slot_keys_jax(seed=seed)
    jst = JaxCEMState(key=keys, dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std),
                      count=jnp.ones((B,), jnp.int32), u_prev=jnp.asarray(x["u_prev"]))
    pst = CEMState(generator=(None,) * B, dist_mue=torch.tensor(mue), stdev=torch.tensor(std),
                   count=np.ones(B, np.int64), u_prev=torch.tensor(x["u_prev"]))
    return keys, jst, pst


def assert_cem_match(u, new, costs, u_j, new_j, costs_j, atol):
    np.testing.assert_allclose(costs.numpy(), np.asarray(costs_j), **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=atol)
    np.testing.assert_allclose(new.dist_mue.numpy(), np.asarray(new_j.dist_mue), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(new.stdev.numpy(), np.asarray(new_j.stdev), rtol=0, atol=atol)
    np.testing.assert_array_equal(new.count, np.asarray(new_j.count))


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_fused_cem_fleet_step_matches_jax(label):
    """One batched fully-fused CEM step (K6) fed the seeds the JAX step
    draws from each slot's key."""
    jctrl, pctrl, jparams, params = pair(label, "cem-tf", cem_config(fully_fused=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = dict(sessions(label, jparams, 15), label=label)
    keys, jst, pst = cem_slot_states(x, jparams, 16)
    psd = (x["key"],)
    jstep = jopt._make_batched_fused_cem_step(B, interpret=True, tile_k=TILE, per_slot_dyn=psd)
    u_j, new_j, costs_j = jstep(jst, *jax_args(x, jparams))
    its = jopt.cem_outer_it
    seeds = np.zeros((its, B), np.int32)
    for b in range(B):
        key = keys[b]
        for i in range(its):
            key, sub = jax.random.split(key)
            seeds[i, b] = int(jax.random.randint(sub, (), 0, 2**31 - 1, jnp.int32))
    _, update = popt._make_batched_fused_cem_step(B, per_slot_dyn=psd)
    u, new, costs = update(pst, *port_args(x, params), torch.tensor(seeds))
    assert_cem_match(u, new, costs, u_j, new_j, costs_j, STEP_ATOL)


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_modular_cem_fleet_step_matches_jax(label):
    """One modular batched CEM step (K1's session-row form) fed the normals
    the JAX step draws from each slot's key."""
    jctrl, pctrl, jparams, params = pair(label, "cem-tf", cem_config())
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = dict(sessions(label, jparams, 17), label=label)
    keys, jst, pst = cem_slot_states(x, jparams, 18)
    psd = (x["key"],)
    jstep, _ = jopt._make_batched_cem_step(B, interpret=True, tile_k=B * KC, per_slot_dyn=psd)
    u_j, new_j, costs_j = jstep(jst, *jax_args(x, jparams))
    U = DIMS[env_of(label)][1]
    keys, draws = list(keys), []
    for _ in range(jopt.cem_outer_it):
        row = []
        for b in range(B):
            keys[b], sub = jax.random.split(keys[b])
            row.append(np.asarray(jax.random.normal(sub, (KC, HF, U), jnp.float32)))
        draws.append(torch.tensor(np.stack(row)))
    step, _ = popt._make_batched_cem_step(B, per_slot_dyn=psd)
    u, new, costs = step(pst, *port_args(x, params), np.ones(B, bool), draws=draws)
    assert_cem_match(u, new, costs, u_j, new_j, costs_j, CEM_REFIT_ATOL)


def grad_population(label, jopt, seed):
    env = env_of(label)
    rng = np.random.default_rng(seed)
    shape = (B, jopt.num_rollouts, HF, DIMS[env][1])
    return {"Q": controls(env, rng, shape),
            "m": (0.05 * rng.standard_normal(shape)).astype(np.float32),
            "v": (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32),
            "ages": rng.integers(0, 20, shape[:2]).astype(np.float32)}


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_rpgd_fleet_update_matches_jax(label):
    """One batched rpgd-tf update (K7's and K1's session-row forms) fed the
    JAX draw of the slot on its resample tick; the other slot keeps."""
    jctrl, pctrl, jparams, params = pair(label, "rpgd-tf", grad_config("rpgd-tf"))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 19)
    p = grad_population(label, jopt, 20)
    keys, psd = slot_keys_jax(seed=3), (x["key"],)
    steps = ADAM_STEPS[:B]
    jstates = JaxRPGDState(
        key=keys, Q=jnp.asarray(p["Q"]),
        adam=JaxAdamState(step=jnp.asarray(steps, jnp.int32), m=jnp.asarray(p["m"]),
                          v=jnp.asarray(p["v"])),
        trajectory_ages=jnp.asarray(p["ages"]), count=jnp.asarray(RPGD_COUNTS, jnp.int32),
        u_prev=jnp.asarray(x["u_prev"]))
    jstep = jopt._make_batched_rpgd_step(B, interpret=True, tile_k=B * jopt.num_rollouts,
                                         per_slot_dyn=psd)
    ju, jnew, jcosts = jstep(jstates, *jax_args(x, jparams))
    n = jopt.num_rollouts - jopt.opt_keep_k
    shape = (n, jopt.interp.number_of_interpolation_inducing_points, jopt.num_control_inputs)
    draws = [None if c % jopt.resamp_per else torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(keys[b])[1], shape, minval=jopt.action_low, maxval=jopt.action_high)))
        for b, c in enumerate(RPGD_COUNTS)]
    states_ = rpgd_slot_states_from_numpy(p["Q"], p["m"], p["v"], steps, p["ages"],
                                          RPGD_COUNTS, x["u_prev"], (None,) * B)
    _, update = popt._make_batched_rpgd_step(B, per_slot_dyn=psd)
    u, new, costs = update(states_, *port_args(x, params), draws)
    assert_states_match(new, jnew, u, ju, costs, jcosts, "ode")
    np.testing.assert_array_equal(new.trajectory_ages.numpy(), np.asarray(jnew.trajectory_ages))


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_gradient_fleet_update_matches_jax(label):
    """One batched gradient-tf update (K7's and K1's session-row forms) fed
    the JAX tails."""
    jctrl, pctrl, jparams, params = pair(label, "gradient-tf", grad_config("gradient-tf"))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 21)
    p = grad_population(label, jopt, 22)
    keys, psd = slot_keys_jax(seed=4), (x["key"],)
    steps = ADAM_STEPS[:B]
    jstates = JaxGradientState(
        key=keys, Q=jnp.asarray(p["Q"]),
        adam=JaxAdamState(step=jnp.asarray(steps, jnp.int32), m=jnp.asarray(p["m"]),
                          v=jnp.asarray(p["v"])),
        count=jnp.asarray(RPGD_COUNTS, jnp.int32), u_prev=jnp.asarray(x["u_prev"]))
    jstep = jopt._make_batched_gradient_step(B, interpret=True, tile_k=B * jopt.num_rollouts,
                                             per_slot_dyn=psd)
    ju, jnew, jcosts = jstep(jstates, *jax_args(x, jparams))
    U, Kg = jopt.num_control_inputs, jopt.num_rollouts
    tails = torch.stack([torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(k)[1], (Kg, 1, U), minval=jopt.action_low, maxval=jopt.action_high,
        dtype=jnp.float32))) for k in keys])
    states_ = gradient_slot_states_from_numpy(p["Q"], p["m"], p["v"], steps, RPGD_COUNTS,
                                              x["u_prev"], (None,) * B)
    _, update = popt._make_batched_gradient_step(B, per_slot_dyn=psd)
    u, new, costs = update(states_, *port_args(x, params), tails)
    assert_states_match(new, jnew, u, ju, costs, jcosts, "ode")
    assert torch.equal(new.Q[:, :, -1:], tails)


@pytest.mark.parametrize("label", FLEET_LABELS)
def test_fused_cem_step_matches_jax(label):
    """One single-session fully-fused CEM step (K5) fed the seeds the JAX step
    draws: the refit distribution, the applied control and the costs."""
    jctrl, pctrl = make_pair(label, "cem-tf", cem_config(K=TILE, fully_fused=True))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    use_fused(jctrl, pctrl, TILE)
    env = env_of(label)
    U = DIMS[env][1]
    rng = np.random.default_rng(23)
    mue = controls(env, rng, (1, HF, U), 0.4)
    std = rng.uniform(0.2, 0.6, (1, HF, U)).astype(np.float32)
    u_prev = controls(env, rng, (U,))
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std), count=jnp.asarray(1, jnp.int32),
        u_prev=jnp.asarray(u_prev))
    popt.opt_state = CEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std), 1,
                              torch.tensor(u_prev))
    key, draws = jopt.opt_state.key, []
    for _ in range(jopt.cem_outer_it):
        key, sub = jax.random.split(key)
        seed = int(jax.random.randint(sub, (1,), 0, 2**31 - 1, jnp.int32)[0])
        draws.append(torch.tensor([seed, 0], dtype=torch.int32))
    jparams = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                     jctrl._assemble_params())
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)
    s = states(label, rng, 1)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s), jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s), params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    np.testing.assert_allclose(st.dist_mue.numpy(), np.asarray(st_j.dist_mue), **UNOM_TOL)
    np.testing.assert_allclose(st.stdev.numpy(), np.asarray(st_j.stdev), **UNOM_TOL)


# ---- the point mass's fast normals, the slots' constants -------------------------------------
@pytest.mark.parametrize("label", ["pointmass", "pointmass_obstacles"])
def test_fast_point_mass_draws_the_fast_normals(label):
    """Over a ``:fast`` point mass both K5 and K6 keep the exact plant and
    draw the fast normals (JAX's fast_sampling=pred.fast_math): their
    counters equal the JAX formulas' bit for bit, K5's costs and K6's equal
    the JAX kernels' fast_sampling forms, and K5's are not the exact
    normals' bit for bit."""
    jctrl, pctrl, jparams, params = pair(label, "cem-tf", cem_config(K=TILE, fully_fused=True),
                                         "ODE:rk4:1:fast")
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    assert model.plant == PLANTS[label][2] and model.fast_sampling and model.fast_math
    assert bool(jopt.predictor.predictor.fast_math)
    U = DIMS["pointmass"][1]
    seed2 = np.array([987654, 2], np.int32)
    idx = np.arange(0, TILE, 5)
    got = cem_counters(torch.tensor(seed2), torch.tensor(idx), TILE, HF, U, TILE).numpy() & MASK
    C, stride = TILE // ROWS, HF * TILE
    r, t, c = idx // (TILE // ROWS), (idx % (TILE // ROWS)) // C, idx % C
    h, j = np.arange(HF, dtype=np.uint64), np.arange(U, dtype=np.uint64)
    with np.errstate(over="ignore"):
        base = (np.uint64(seed2[0]) * np.uint64(FNV) + (np.uint64(seed2[1]) + t.astype(np.uint64))
                * np.uint64(stride * U) + (r * C + c).astype(np.uint64))
        ref = (base[:, None, None] + h[None, :, None] * np.uint64(TILE)
               + j[None, None, :] * np.uint64(stride)) & np.uint64(MASK)
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    run, _, jpack = jopt._build_fused_cem(interpret=True, tile_k=TILE)
    rng = np.random.default_rng(24)
    s0, u_prev = states(label, rng, 1)[0], controls("pointmass", rng, (U,))
    mue = controls("pointmass", rng, (HF, U), 0.5)
    std = np.full((HF, U), 0.4, np.float32)
    ref5 = np.asarray(run(jnp.asarray(s0), jnp.asarray(mue), jnp.asarray(std),
                          jpack(jparams, jnp.asarray(u_prev)), jnp.asarray(seed2))).reshape(-1)
    lo, hi = lim(label)
    args = (torch.tensor(s0), torch.tensor(mue), torch.tensor(std),
            pack(params, torch.tensor(u_prev)), torch.tensor(seed2), lo, hi, TILE, TILE)
    got5 = fused_cem_costs(model, *args).numpy()
    np.testing.assert_allclose(got5, ref5, **COST_TOL)
    exact = fused_cem_costs(ode.rollout_model(pair(label, "cem-tf", cem_config(
        K=TILE, fully_fused=True))[1].optimizer)[0], *args).numpy()
    assert not np.array_equal(got5, exact)  # the fast normals, an ulp or so from the exact
    ref6, got6, k6_args, _ = k6_case(label, "ODE:rk4:1:fast")
    np.testing.assert_allclose(got6.numpy(), ref6, **COST_TOL)
    seed_b = k6_args[5]
    k = torch.arange(KC).expand(B, KC)
    cps = KC // ROWS
    with np.errstate(over="ignore"):
        base6 = (seed_b.numpy().astype(np.uint64)[:, None] * np.uint64(FNV)
                 + ((k.numpy() // cps) * cps + k.numpy() % cps).astype(np.uint64))
    ref_c = (base6[:, :, None, None] + h[None, None, :, None] * np.uint64(KC)
             + j[None, None, None, :] * np.uint64(HF * KC)) & np.uint64(MASK)
    np.testing.assert_array_equal(cols_counters(seed_b, k, KC, HF, U).numpy() & MASK,
                                  ref_c.astype(np.int64))


@pytest.mark.parametrize("label", LABELS)
def test_per_slot_dyn_takes_each_plants_constants(label):
    """A fleet over each plant takes its environment's constant per slot:
    ``update_slot_dyn`` moves that column of the sessions' rows alone, and
    a name that is no scalar constant of the plant is refused."""
    env = env_of(label)
    key = SLOT_DYN[env]
    ctrl = port_ctrl(label, "mppi", mppi_config(num_rollouts=KC, mpc_horizon=HF),
                     cls=BatchedMPCController, num_slots=2, per_slot_dyn=(key,))
    default = ctrl._slot_dyn_defaults[key]
    assert default == pytest.approx(float(ctrl.predictor.default_params()[key]))
    ctrl.update_slot_dyn(1, {key: 1.25 * default})
    params = ctrl._assemble_params()
    dyn = ctrl._dyn_with_slots(params["dyn"])
    model, _ = ode.rollout_model(ctrl.optimizer)
    _, slot_keys = split_slot_keys(model.param_keys, (key,))
    attrs = {k: torch.as_tensor(v) for k, v in ctrl.slot_attrs.items()}
    rows = make_slot_packer(model.param_keys, slot_keys, {}, 2, CPU)(
        torch.zeros(2, DIMS[env][1]), dyn, params["cost"], attrs)
    col = model.param_keys.index(f"d_{key}")
    assert rows[0, col] == pytest.approx(default) and rows[1, col] == pytest.approx(1.25 * default)
    others = [i for i in range(len(model.param_keys)) if i != col]
    assert torch.equal(rows[0, others], rows[1, others])
    with pytest.raises(ValueError, match="per_slot_dyn key"):
        port_ctrl(label, "mppi", mppi_config(num_rollouts=KC, mpc_horizon=HF),
                  cls=BatchedMPCController, num_slots=2, per_slot_dyn=("no_such_constant",))


def test_arm2_per_slot_l1_moves_the_dynamics_alone_as_in_jax():
    """arm2's cost mirrors ``l1`` from its dynamics once, at configure: a
    per-slot ``l1`` then moves each session's dynamics, and its cost's
    ``l1`` stays the shared one, in both packages; one MPPI fleet update
    with per-slot ``l1`` matches the JAX package's."""
    jctrl, pctrl, jparams, params = pair("arm2")
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions("arm2", jparams, 25)
    assert x["key"] == "l1" and not np.allclose(x["slot"][0], x["slot"][1])
    _, _, make_run = jopt._build_fused_mppi(build_step=False, interpret=True, tile_k=TILE,
                                            slot_extra_keys=("d_l1",))
    assert "c_l1" in make_run.shared_keys and "d_l1" in make_run.slot_keys
    rows = port_rows(popt, x, params)
    model, _ = ode.rollout_model(popt)
    keys = list(model.param_keys)
    np.testing.assert_allclose(rows[:, keys.index("d_l1")].numpy(), x["slot"])
    assert torch.all(rows[:, keys.index("c_l1")] == params["cost"]["l1"])
    U = DIMS["arm2"][1]
    _, jupdate = jopt._make_batched_semi_fused_step(B, interpret=True, tile_k=TILE,
                                                    per_slot_dyn=("l1",))
    _, update = popt._make_batched_semi_fused_step(B, per_slot_dyn=("l1",))
    rng = np.random.default_rng(26)
    u_nom = controls("arm2", rng, (B, 1, HF, U), 0.4)
    P = jopt.interp.number_of_interpolation_inducing_points
    T, C = (B * KC) // TILE, TILE // ROWS
    eps = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    u_ref, c_ref = jupdate(JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32),
                                        u_nom=jnp.asarray(u_nom), u_prev=jnp.asarray(x["u_prev"])),
                           *jax_args(x, jparams), jnp.asarray(eps))
    u_got, costs = update(MPPIState((None,) * B, torch.tensor(u_nom), torch.tensor(x["u_prev"])),
                          *port_args(x, params), eps_from_tiles(torch.tensor(eps), B))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **COST_TOL)
    np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref), **FLEET_UNOM_TOL)


# ---- on a card: every plant's instance of each form against its plain version ---------------
SLICE_PLANTS = [p for p in kernels.PLANT_IDS if p not in kernels.CARTPOLE_PLANTS]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["K4", "K5", "K6", "K1's session-row form",
                                  "K7's session-row form", "K4's emit_terminal form",
                                  "K1's session-row emit_terminal form",
                                  "K7's session-row value_spec form"])
@pytest.mark.parametrize("plant", SLICE_PLANTS)
def test_cuda_fleet_instances_match_plain_versions(cuda_device, form, plant):
    """Each plant's instance of K4, K5, K6 and the session-row forms of K1
    and K7 (with the emit_terminal forms of K4 and session-row K1 and the
    session-row value_spec form of K7) against its plain version on the
    same card tensors, at ragged sizes (blocks straddle sessions), K5 and
    K6 equal to K1 over their regenerated controls, the emit forms' costs
    equal to their kernels' (test_torch_kernels.py's tolerance; x_H to
    1e-4 of its largest entry)."""
    label = label_of(plant)
    spec = "ODE:rk4:1:fast" if plant.endswith("_fast") else "ODE"
    ctrl = port_ctrl(label, spec=spec)
    model, pack = ode.rollout_model(ctrl.optimizer)
    assert model.plant == plant and plant in kernels.KERNEL_PLANTS[form]
    dev = cuda_device
    S, U = kernels.PLANT_DIMS[plant]
    gen = torch.Generator(device=dev).manual_seed(0)
    low, high = (torch.as_tensor(v, device=dev) for v in limits(PLANTS[label][0]))
    mid, half = 0.5 * (low + high), 0.5 * (high - low)
    Bc, Kc, Hc = 3, 200, 37
    rows = pack(ctrl._assemble_params(), mid).to(dev).repeat(Bc, 1)
    rows[:, 0] *= torch.linspace(0.9, 1.1, Bc, device=dev)  # a dynamics constant per session
    s0 = torch.as_tensor(states(label, np.random.default_rng(0), Bc), device=dev)
    tol = dict(rtol=1e-4, atol=1e-3)
    if form in ("K5", "K6"):
        mue = torch.clamp(mid + 0.3 * half * torch.randn(Bc, Hc, U, generator=gen, device=dev),
                          low, high)
        std = (0.5 * half).expand(Bc, Hc, U).contiguous()
        if form == "K5":
            Kf, tile = 704, 64
            seed2 = torch.tensor([77, 0], dtype=torch.int32, device=dev)
            args = (model, s0[0], mue[0], std[0], rows[0], seed2, low, high, Kf, tile)
            got = fused_cem_costs(*args)
            torch.testing.assert_close(got, fused_cem_costs_plain(*args), **tol)
            Q = regen_controls(seed2, torch.arange(Kf, device=dev), mue[0], std[0], low, high,
                               Kf, tile, fast=model.fast_math)
            assert torch.equal(got, cost_rollout(model, s0[0].expand(Kf, -1).contiguous(), Q,
                                                 rows[0]))
            return
        Kf = 208
        seed_b = torch.tensor([5, 6, 7], dtype=torch.int32, device=dev)
        args = (model, s0, mue, std, rows, seed_b, low, high, Kf)
        got = fused_cem_cols(*args)
        torch.testing.assert_close(got, fused_cem_cols_plain(*args), **tol)
        Q = regen_cols(seed_b, torch.arange(Kf, device=dev).expand(Bc, Kf), mue, std, low, high,
                       Kf, fast=model.fast_math)
        for b in range(Bc):
            assert torch.equal(got[b], cost_rollout(model, s0[b].expand(Kf, -1).contiguous(),
                                                    Q[b].contiguous(), rows[b]))
        return
    x_tol = dict(rtol=1e-4, atol=1e-4)
    if form in ("K4", "K4's emit_terminal form"):
        W = torch.as_tensor(interpolation_matrix(Hc, 10), device=dev)
        u_nom = torch.clamp(mid + 0.2 * half * torch.randn(Bc, Hc, U, generator=gen, device=dev),
                            low, high)
        eps = 0.2 * torch.randn(Bc, W.shape[0], U, Kc, generator=gen, device=dev)
        args = (model, s0, u_nom, rows, eps, W, low, high, 1.0, 1.0, 1000.0)
        if form == "K4":
            torch.testing.assert_close(mppi_cost_cols(*args), mppi_cost_cols_plain(*args), **tol)
            return
        (cost, x_h), (_, ref_x) = mppi_cost_cols_emit(*args), mppi_cost_cols_emit_plain(*args)
        assert torch.equal(cost, mppi_cost_cols(*args))
        torch.testing.assert_close(x_h, ref_x, **x_tol)
        return
    Q = low + (high - low) * torch.rand(Bc * Kc, Hc, U, generator=gen, device=dev)
    args = (model, s0.repeat_interleave(Kc, dim=0), Q, rows)
    if form == "K1's session-row form":
        torch.testing.assert_close(cost_rollout_cols(*args), cost_rollout_cols_plain(*args), **tol)
        return
    if form == "K1's session-row emit_terminal form":
        (cost, x_h), (_, ref_x) = cost_rollout_cols_emit(*args), cost_rollout_cols_emit_plain(*args)
        assert torch.equal(cost, cost_rollout_cols(*args))
        torch.testing.assert_close(x_h, ref_x, **x_tol)
        return
    if form == "K7's session-row value_spec form":
        g = torch.Generator(device=dev).manual_seed(S)
        ops = [torch.randn(S, 8, generator=g, device=dev) / S ** 0.5, torch.zeros(8, device=dev),
               torch.randn(8, 1, generator=g, device=dev), torch.zeros(1, device=dev)]
        (cost, dQ), (ref_cost, ref_dQ) = (grad_cost_rollout_cols_value(*args, ops),
                                          grad_cost_rollout_cols_plain(*args, value_ops=ops))
        torch.testing.assert_close(cost, ref_cost, **tol)
        if not plant.startswith("arm2"):
            assert float((dQ - ref_dQ).abs().max()) <= 2e-5 * float(ref_dQ.abs().max()) + 1e-6
            return
        args64 = (model, args[1].double(), Q.double(), rows.double())
        ref64 = grad_cost_rollout_cols_plain(*args64, value_ops=[o.double() for o in ops])[1]
        err, plain_err = ((d.double() - ref64).abs().max() for d in (dQ, ref_dQ))
        assert float(err) <= F64_FACTOR * float(plain_err) + 1e-6 * float(ref64.abs().max())
        return
    (cost, dQ), (ref_cost, ref_dQ) = grad_cost_rollout_cols(*args), grad_cost_rollout_cols_plain(
        *args)
    torch.testing.assert_close(cost, ref_cost, **tol)
    if not plant.startswith("arm2"):
        assert float((dQ - ref_dQ).abs().max()) <= 2e-5 * float(ref_dQ.abs().max()) + 1e-6
        return
    # The arm's dQ to float64 (chip_smoke.py F64_HELD_PLANTS): no further from
    # the float64 plain version than F64_FACTOR times the float32 one is.
    ref64 = grad_cost_rollout_cols_plain(model, args[1].double(), Q.double(), rows.double())[1]
    err, plain_err = ((d.double() - ref64).abs().max() for d in (dQ, ref_dQ))
    assert float(err) <= F64_FACTOR * float(plain_err) + 1e-6 * float(ref64.abs().max())
