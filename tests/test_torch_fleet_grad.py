"""The port's gradient fleets against the JAX package: ``batched-mpc``
serving RPGD (each of its seven names) and gradient-tf sessions over the
cartpole ODE, an MLP, ``"ODE+res"`` and a sparse GP, every Adam iteration
one launch of a gradient kernel's session-row form (K7, K8, K9, K10) and
the final scoring one of its cost kernel's (K1, K11, K12, K14); and the
modular batched CEM step over K1's form.

Each session-row form's plain version equals its single-session plain
version session by session, at 100 rollouts a session (blocks and
16-rollout groups straddle sessions) and at one session.  One batched
update of each optimizer, fed the JAX draws (re-split from each slot's
JAX key as the JAX step splits it; rpgd-particle's categorical picks
through the midpoints of their cumulative weights, as
tests/test_torch_rpgd.py feeds the single-session step), is held to the
JAX package's ``_make_batched_*_step`` with its kernels in interpret mode
(one tile of B*K rollouts) from the same per-session states, Adam
moments and counters, targets, previous controls and pole lengths: costs
and the population to tests/test_torch_rpgd.py's bounds (COST_TOL, Q_TOL,
MOMENT_TOL: float32 sums over 10 rk4 steps and two Keras-Adam steps whose
gradients agree to the gradient kernels' bounds), the ages, counters and
Adam steps exactly.  Slots 0 and 2 of the three are on their resample
tick and slot 1 is not, so one update takes both surgery branches.  The
batched CEM ``refit_from_Q`` and one step (fed the JAX normals) are held
to JAX's to tests/test_torch_fleet_cem.py's bounds.  The controller's own
behaviour is checked on the port alone: results independent of B, a slot
equal to a single ``mpc`` controller, the mask's freeze bit for bit (Adam
moments, counters, ages and generator included), ``reset_slot``, the NaN
guard, the gates and the refusals.  On a machine with a card, each form
is held to its plain version (``-m cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.ops.common import AdamState as JaxAdamState
from control_toolkit_tpu.optimizers.cem import CEMState as JaxCEMState
from control_toolkit_tpu.optimizers.gradient import GradientState as JaxGradientState
from control_toolkit_tpu.optimizers.rpgd import RPGDState as JaxRPGDState
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout, cost_rollout_cols, cost_rollout_cols_plain, cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import (
    gp_grad_cost_rollout, gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_plain,
    gp_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.gp_rollout import flatten_gp_weights
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_cols, grad_cost_rollout_cols_plain,
    grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
    neural_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (
    residual_grad_cost_rollout, residual_grad_cost_rollout_cols,
    residual_grad_cost_rollout_cols_plain, residual_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural, ode, residual
from control_toolkit_tpu_torch.utils.convert import (
    gradient_slot_states_from_numpy, params_from_numpy, rpgd_slot_states_from_numpy,
)
from test_torch_fleet_learned import COST_WEIGHTS, specs  # noqa: F401  (fixture)
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, LIMITS
from test_torch_residual import bench_residual
from test_torch_rpgd import COST_TOL, MOMENT_TOL, Q_TOL

B, KC, H = 3, 32, 10
# Slots 0 and 2 on their resample tick (resamp_per 10), slot 1 not.
COUNTS = (10, 7, 20)
ADAM_STEPS = (4, 9, 2)
RPGD_NAMES = ("rpgd-tf", "rpgd", "dist-adam-resamp2-tf", "rpgd-me-tf", "rpgd-me-param-tf",
              "rpgd-ml-tf", "rpgd-particle-tf")
MODELS = ("ode", "mlp", "residual", "gp")
# The GP's gradients agree with the JAX package's to test_torch_gp.py's
# GRAD_TOL (rtol 2e-3): its Adam moments are held to that relative bound.
GP_MOMENT_TOL = dict(rtol=2e-3, atol=1e-5)
# The batched CEM refit and step: tests/test_torch_fleet_cem.py's bounds.
CEM_COST_TOL = dict(atol=2e-4, rtol=2e-5)
CEM_REFIT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def grad_config(name: str, Kc: int = KC, **extra) -> dict:
    """A small configuration of ``name`` (RPGD: both surgery branches within
    a few ticks; rpgd-particle: a temperature whose cumulative weights a
    pick's midpoint resolves)."""
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": Kc,
           "learning_rate": 0.05, "gradmax_clip": 5, "warmup": False}
    if name.startswith("gradient"):
        cfg["gradient_steps"] = 2
    else:
        cfg.update(outer_its=2, opt_keep_k_ratio=0.25, resamp_per=10,
                   period_interpolation_inducing_points=5, SAMPLING_DISTRIBUTION="uniform",
                   sample_stdev=0.5)
        if name == "rpgd-ml-tf":
            cfg["maximum_entropy_alpha"] = 0.1
        if name == "rpgd-particle-tf":
            cfg["particle_temperature"] = 50.0
    cfg.update(extra)
    return cfg


def spec_of(specs, model: str) -> str:  # noqa: F811
    return "ODE" if model == "ode" else specs[model]


def make_pair(name: str, spec: str, cfg: dict):
    """The JAX and the port ``mpc`` controller of ``name`` over ``spec`` (the
    residual with the same nonzero weights in both)."""
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                   config={"optimizer": name, "controller_logging": False})
    jctrl.configure(optimizer_name=name, predictor_specification=spec,
                    optimizer_config=dict(cfg))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": name,
                                  "controller_logging": False})
    pctrl.configure(optimizer_name=name, predictor_specification=spec,
                    optimizer_config=dict(cfg))
    if spec == "ODE+res":
        jpred = jctrl.optimizer.predictor.predictor
        res = bench_residual(jpred._res)
        jpred.set_residual(res)
        jctrl._dyn_params = None
        pctrl.optimizer.predictor.predictor.set_residual(res)
    return jctrl, pctrl


def per_slot_dyn(model: str) -> tuple:
    return ("L",) if model in ("ode", "residual") else ()


def with_slot_dyn(dyn: dict, model: str, L):
    """``dyn`` with the sessions' pole lengths, at the top (an ODE) or in the
    residual's base."""
    if model == "ode":
        return dict(dyn, L=L)
    if model == "residual":
        return dict(dyn, base=dict(dyn["base"], L=L))
    return dyn


def population(jopt, seed: int) -> dict:
    """Per-session states, targets, pole lengths, previous controls,
    populations, Adam moments and ages, made with numpy."""
    rng = np.random.default_rng(seed)
    shape = (B, jopt.num_rollouts, jopt.mpc_horizon, jopt.num_control_inputs)

    def f32(a):
        return np.asarray(a, np.float32)

    return {
        "s": f32(rng.uniform(-0.2, 0.2, (B, 1, 4))),
        "target": f32(np.linspace(-0.3, 0.3, B)),
        "L": f32(np.linspace(0.4, 0.6, B)),
        "u_prev": f32(rng.uniform(-0.5, 0.5, (B, 1))),
        "Q": f32(rng.uniform(-1.0, 1.0, shape)),
        "m": f32(0.05 * rng.standard_normal(shape)),
        "v": f32(0.01 * rng.uniform(0.1, 1.0, shape)),
        "ages": f32(rng.integers(0, 20, shape[:2])),
    }


def slot_keys_jax(B_: int = B):
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(B_)])


def jax_args(jctrl, x: dict, model: str):
    jp = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), jctrl._assemble_params())
    return (jnp.asarray(x["s"]), with_slot_dyn(jp["dyn"], model, jnp.asarray(x["L"])),
            jp["cost"], {"target_position": jnp.asarray(x["target"])})


def port_args(jctrl, x: dict, model: str):
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jctrl._assemble_params()), CPU)
    return (torch.tensor(x["s"]), with_slot_dyn(pp["dyn"], model, torch.tensor(x["L"])),
            pp["cost"], {"target_position": torch.tensor(x["target"])})


def jax_rpgd_draws(jopt, keys, costs) -> list:
    """Each slot's draw as the JAX step makes it from its key (a slot off
    its resample tick: None): the inducing-point controls, or
    rpgd-particle's (uniforms, jitter) with each categorical pick at the
    midpoint of its interval of the cumulative weights of JAX's costs."""
    n = jopt.num_rollouts - jopt.opt_keep_k
    shape = (n, jopt.interp.number_of_interpolation_inducing_points, jopt.num_control_inputs)
    draws = []
    for b, count in enumerate(COUNTS):
        if count % jopt.resamp_per:
            draws.append(None)
            continue
        sub = jax.random.split(keys[b])[1]
        if hasattr(jopt, "particle_temperature"):
            kc, kj = jax.random.split(sub)
            cost = jnp.asarray(costs[b])
            idx = np.asarray(jax.random.categorical(
                kc, -(cost - jnp.min(cost)) / jopt.particle_temperature, shape=(n,)))
            c64 = np.asarray(cost, np.float64)
            w = np.exp(-(c64 - c64.min()) / jopt.particle_temperature)
            cdf = np.concatenate([[0.0], np.cumsum(w / w.sum())])
            jitter = jopt.sample_stdev * jax.random.normal(kj, shape, jnp.float32)
            draws.append((torch.tensor(0.5 * (cdf[idx] + cdf[idx + 1]), dtype=torch.float32),
                          torch.tensor(np.asarray(jitter))))
        elif jopt.sampling_distribution == "normal":
            draws.append(torch.tensor(np.asarray(
                jopt.sample_mean + jopt.sample_stdev * jax.random.normal(sub, shape))))
        else:
            draws.append(torch.tensor(np.asarray(jax.random.uniform(
                sub, shape, minval=jopt.action_low, maxval=jopt.action_high))))
    return draws


def assert_states_match(new, jnew, u, ju, costs, jcosts, model):
    moment_tol = GP_MOMENT_TOL if model == "gp" else MOMENT_TOL
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), **Q_TOL)
    np.testing.assert_allclose(new.Q.numpy(), np.asarray(jnew.Q), **Q_TOL)
    np.testing.assert_allclose(new.adam.m.numpy(), np.asarray(jnew.adam.m), **moment_tol)
    np.testing.assert_allclose(new.adam.v.numpy(), np.asarray(jnew.adam.v), **moment_tol)
    np.testing.assert_array_equal(new.adam.step, np.asarray(jnew.adam.step))
    np.testing.assert_array_equal(new.count, np.asarray(jnew.count))
    np.testing.assert_array_equal(new.u_prev.numpy(), u.numpy())


@pytest.mark.parametrize("name,model", [(n, "ode") for n in RPGD_NAMES]
                         + [("rpgd-tf", m) for m in MODELS[1:]])
def test_batched_rpgd_update_matches_jax(specs, name, model):  # noqa: F811
    """One batched RPGD update from the JAX draws against the JAX package's
    ``_make_batched_rpgd_step``: costs, controls, the population, the Adam
    moments, steps and counters, the ages."""
    jctrl, pctrl = make_pair(name, spec_of(specs, model), grad_config(name))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = population(jopt, seed=len(name) + len(model))
    keys = slot_keys_jax()
    jstates = JaxRPGDState(
        key=keys, Q=jnp.asarray(x["Q"]),
        adam=JaxAdamState(step=jnp.asarray(ADAM_STEPS, jnp.int32), m=jnp.asarray(x["m"]),
                          v=jnp.asarray(x["v"])),
        trajectory_ages=jnp.asarray(x["ages"]), count=jnp.asarray(COUNTS, jnp.int32),
        u_prev=jnp.asarray(x["u_prev"]))
    jstep = jopt._make_batched_rpgd_step(B, interpret=True, tile_k=B * KC,
                                         per_slot_dyn=per_slot_dyn(model))
    ju, jnew, jcosts = jstep(jstates, *jax_args(jctrl, x, model))

    states = rpgd_slot_states_from_numpy(x["Q"], x["m"], x["v"], ADAM_STEPS, x["ages"], COUNTS,
                                         x["u_prev"], (None,) * B)
    _, update = popt._make_batched_rpgd_step(B, per_slot_dyn=per_slot_dyn(model))
    draws = jax_rpgd_draws(jopt, keys, np.asarray(jcosts))
    assert [d is None for d in draws] == [False, True, False]
    u, new, costs = update(states, *port_args(jctrl, x, model), draws)
    assert_states_match(new, jnew, u, ju, costs, jcosts, model)
    np.testing.assert_array_equal(new.trajectory_ages.numpy(), np.asarray(jnew.trajectory_ages))


@pytest.mark.parametrize("model", MODELS)
def test_batched_gradient_update_matches_jax(specs, model):  # noqa: F811
    """One batched gradient-tf update from the JAX tails against the JAX
    package's ``_make_batched_gradient_step``."""
    jctrl, pctrl = make_pair("gradient-tf", spec_of(specs, model), grad_config("gradient-tf"))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = population(jopt, seed=40 + len(model))
    keys = slot_keys_jax()
    jstates = JaxGradientState(
        key=keys, Q=jnp.asarray(x["Q"]),
        adam=JaxAdamState(step=jnp.asarray(ADAM_STEPS, jnp.int32), m=jnp.asarray(x["m"]),
                          v=jnp.asarray(x["v"])),
        count=jnp.asarray(COUNTS, jnp.int32), u_prev=jnp.asarray(x["u_prev"]))
    jstep = jopt._make_batched_gradient_step(B, interpret=True, tile_k=B * KC,
                                             per_slot_dyn=per_slot_dyn(model))
    ju, jnew, jcosts = jstep(jstates, *jax_args(jctrl, x, model))

    tails = torch.stack([torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(k)[1], (KC, 1, 1), minval=jopt.action_low, maxval=jopt.action_high,
        dtype=jnp.float32))) for k in keys])
    states = gradient_slot_states_from_numpy(x["Q"], x["m"], x["v"], ADAM_STEPS, COUNTS,
                                             x["u_prev"], (None,) * B)
    _, update = popt._make_batched_gradient_step(B, per_slot_dyn=per_slot_dyn(model))
    u, new, costs = update(states, *port_args(jctrl, x, model), tails)
    assert_states_match(new, jnew, u, ju, costs, jcosts, model)
    assert torch.equal(new.Q[:, :, -1:], tails)


# ---- the modular batched CEM step -------------------------------------------
CEM_CONFIG = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 64,
              "cem_outer_it": 2, "cem_best_k": 8, "cem_initial_action_stdev": 0.5,
              "cem_stdev_min": 0.01, "warmup": False}


def cem_states(x: dict):
    jst = JaxCEMState(key=slot_keys_jax(), dist_mue=jnp.asarray(x["mue"])[:, None],
                      stdev=jnp.asarray(x["std"])[:, None], count=jnp.zeros(B, jnp.int32),
                      u_prev=jnp.asarray(x["u_prev"]))
    pst = CEMState(generator=(None,) * B, dist_mue=torch.tensor(x["mue"])[:, None],
                   stdev=torch.tensor(x["std"])[:, None], count=np.zeros(B, np.int64),
                   u_prev=torch.tensor(x["u_prev"]))
    return jst, pst


def cem_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    Kc = CEM_CONFIG["num_rollouts"]
    return {"s": rng.uniform(-0.2, 0.2, (B, 1, 4)).astype(np.float32),
            "target": np.linspace(-0.3, 0.3, B).astype(np.float32),
            "L": np.linspace(0.4, 0.6, B).astype(np.float32),
            "u_prev": rng.uniform(-0.5, 0.5, (B, 1)).astype(np.float32),
            "mue": rng.uniform(-0.3, 0.3, (B, H, 1)).astype(np.float32),
            "std": rng.uniform(0.2, 0.6, (B, H, 1)).astype(np.float32),
            "Q": np.clip(rng.normal(0.0, 0.4, (B, Kc, H, 1)), -1.0, 1.0).astype(np.float32)}


def test_batched_cem_refit_from_q_matches_jax():
    """The modular batched CEM's evaluate-and-refit of a given population
    (one launch of K1's session-row form) against JAX's ``refit_from_Q``,
    with per-slot pole lengths."""
    jctrl, pctrl = make_pair("cem-tf", "ODE", CEM_CONFIG)
    x = cem_inputs(21)
    jst, pst = cem_states(x)
    _, jrefit = jctrl.optimizer._make_batched_cem_step(B, interpret=True, tile_k=B * 64,
                                                       per_slot_dyn=("L",))
    _, refit = pctrl.optimizer._make_batched_cem_step(B, per_slot_dyn=("L",))
    ref = jrefit(jst, *jax_args(jctrl, x, "ode"), jnp.asarray(x["Q"]))
    got = refit(pst, *port_args(jctrl, x, "ode"), torch.tensor(x["Q"]))
    assert got[0].shape == (B, 1, H, 1) and got[3].shape == (B, 64)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), **CEM_COST_TOL)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=CEM_REFIT_ATOL, rtol=0)


def test_batched_cem_step_matches_jax():
    """One modular batched CEM step fed the JAX normals (each slot's key
    split per outer iteration as the JAX step splits it): controls, costs
    and the shifted distributions against JAX's."""
    jctrl, pctrl = make_pair("cem-tf", "ODE", CEM_CONFIG)
    x = cem_inputs(22)
    jst, pst = cem_states(x)
    jstep, _ = jctrl.optimizer._make_batched_cem_step(B, interpret=True, tile_k=B * 64,
                                                      per_slot_dyn=("L",))
    step, _ = pctrl.optimizer._make_batched_cem_step(B, per_slot_dyn=("L",))
    ju, jnew, jcosts = jstep(jst, *jax_args(jctrl, x, "ode"))
    draws = []
    keys = list(slot_keys_jax())
    for _ in range(CEM_CONFIG["cem_outer_it"]):
        row = []
        for b in range(B):
            keys[b], sub = jax.random.split(keys[b])
            row.append(np.asarray(jax.random.normal(sub, (64, H, 1), jnp.float32)))
        draws.append(torch.tensor(np.stack(row)))
    u, new, costs = step(pst, *port_args(jctrl, x, "ode"), np.ones(B, bool), draws=draws)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), **CEM_COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=CEM_REFIT_ATOL, rtol=0)
    np.testing.assert_allclose(new.dist_mue.numpy(), np.asarray(jnew.dist_mue),
                               atol=CEM_REFIT_ATOL, rtol=0)
    np.testing.assert_allclose(new.stdev.numpy(), np.asarray(jnew.stdev),
                               atol=CEM_REFIT_ATOL, rtol=0)
    np.testing.assert_array_equal(new.count, np.asarray(jnew.count))


# ---- the session-row forms --------------------------------------------------
FORMS = {"k1": (cost_rollout_cols, cost_rollout_cols_plain, cost_rollout_plain),
         "k7": (grad_cost_rollout_cols, grad_cost_rollout_cols_plain, grad_cost_rollout_plain),
         "k8": (neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
                neural_grad_cost_rollout_plain),
         "k9": (residual_grad_cost_rollout_cols, residual_grad_cost_rollout_cols_plain,
                residual_grad_cost_rollout_plain),
         "k10": (gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_plain,
                 gp_grad_cost_rollout_plain)}
FORM_MODEL = {"k1": "ode", "k7": "ode", "k8": "mlp", "k9": "residual", "k10": "gp"}


def form_problem(form: str, pctrl, B_: int, Kc: int, device=CPU, seed: int = 5):
    """A session-row form's operands: ``(model, s0 [B*K,S], Q [B*K,H,U],
    pvec_b [B,N], *weights)``, the sessions' rows differing in target,
    previous control and (ODE, residual) pole length."""
    popt, params = pctrl.optimizer, pctrl._assemble_params()
    gen = torch.Generator().manual_seed(seed)
    model = {"ode": lambda: ode.rollout_model(popt)[0],
             "mlp": lambda: neural.net_model(popt)[0],
             "residual": lambda: residual.residual_model(popt)[0],
             "gp": lambda: gp.gp_model(popt)[0]}[FORM_MODEL[form]]()
    dyn, slot = params["dyn"], ()
    if FORM_MODEL[form] in ("ode", "residual"):
        base = dyn if FORM_MODEL[form] == "ode" else dyn["base"]
        dyn, slot = dict(base, L=torch.linspace(0.35, 0.65, B_)), ("L",)
    _, slot_keys = split_slot_keys(model.param_keys, slot)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B_, CPU)(
        0.3 * torch.randn(B_, 1, generator=gen), dyn, params["cost"],
        {"target_position": torch.linspace(-0.2, 0.2, B_)})
    s0 = (0.05 * torch.randn(B_, 4, generator=gen)).repeat_interleave(Kc, dim=0)
    Q = torch.clamp(0.3 * torch.randn(B_ * Kc, H, 1, generator=gen), -1.0, 1.0)
    weights = {"ode": lambda: (), "mlp": lambda: (params["dyn"]["net"],),
               "residual": lambda: (params["dyn"]["res"],),
               "gp": lambda: (flatten_gp_weights(params["dyn"]["gp"]),)}[FORM_MODEL[form]]()
    args = (model, s0, Q, pvec_b, *weights)
    return tuple(_to(a, device) for a in args)


def _to(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, dict):
        return {k: _to(v, device) for k, v in a.items()}
    return a


def single_args(args: tuple, b: int) -> tuple:
    model, s0, Q, pvec_b, *weights = args
    K = s0.shape[0] // pvec_b.shape[0]
    rows = slice(b * K, (b + 1) * K)
    return (model, s0[rows], Q[rows], pvec_b[b], *weights)


def form_pair(specs, form: str, Kc: int):  # noqa: F811
    name = "cem-tf" if form == "k1" else "rpgd-tf"
    cfg = CEM_CONFIG if form == "k1" else grad_config("rpgd-tf")
    return make_pair(name, spec_of(specs, FORM_MODEL[form]), dict(cfg, num_rollouts=Kc))[1]


@pytest.mark.parametrize("B_,Kc", [(3, 100), (1, 64)])
@pytest.mark.parametrize("form", list(FORMS))
def test_cols_plain_is_the_single_session_plain_version_per_session(specs, form, B_,  # noqa: F811
                                                                    Kc):
    """Each form's plain version (the wrapper on CPU tensors), over B_
    sessions of Kc rollouts, equals the single-session plain version run
    with session b's row over its rollouts: the costs and dQ, to float32
    rounding of a batched matmul (the ODE forms exactly)."""
    cols, cols_plain, single = FORMS[form]
    args = form_problem(form, form_pair(specs, form, Kc), B_, Kc)
    got = cols(*args)
    ref = [single(*single_args(args, b)) for b in range(B_)]
    tol = dict(rtol=0, atol=0) if FORM_MODEL[form] == "ode" else dict(rtol=1e-6, atol=1e-5)
    if form == "k1":
        assert got.shape == (B_, Kc) and torch.equal(got, cols_plain(*args))
        torch.testing.assert_close(got, torch.stack(ref), **tol)
        return
    cost, dQ = got
    assert cost.shape == (B_, Kc) and dQ.shape == (B_ * Kc, H, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, cols_plain(*args)))
    torch.testing.assert_close(cost, torch.stack([r[0] for r in ref]), **tol)
    torch.testing.assert_close(dQ, torch.cat([r[1] for r in ref]), **tol)


def test_cols_forms_refuse_mismatched_shapes():
    model = ode.rollout_model(form_pair({}, "k1", 8).optimizer)[0]
    with pytest.raises(ValueError, match="pvec_b"):
        cost_rollout_cols(model, torch.zeros(10, 4), torch.zeros(10, H, 1), torch.zeros(3, 15))
    with pytest.raises(ValueError, match="pvec_b"):
        grad_cost_rollout_cols(model, torch.zeros(9, 4), torch.zeros(9, H, 1), torch.zeros(15))


# ---- the controller ---------------------------------------------------------
def fleet(spec: str, num_slots: int, optimizer: str = "rpgd-tf", model: str = "ode",
          Kc: int = KC, **extra) -> BatchedMPCController:
    """A port batched-mpc gradient fleet on the CPU (per-slot pole lengths
    over an ODE or the residual's base)."""
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "device": "cpu",
                                        "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=grad_config(optimizer, Kc, **extra),
                   cost_function_config=COST_WEIGHTS, num_slots=num_slots,
                   per_slot_dyn=per_slot_dyn(model))
    if spec == "ODE+res":
        pred = ctrl.optimizer.predictor.predictor
        gen = torch.Generator().manual_seed(11)
        pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen)
                           if k.startswith("w") else v for k, v in pred._res.items()})
    return ctrl


def states(n, seed=3):
    return np.random.default_rng(seed).uniform(-0.2, 0.2, (n, 4)).astype(np.float32)


FLEETS = [("rpgd-tf", "ode"), ("gradient-tf", "ode"), ("rpgd-particle-tf", "ode"),
          ("rpgd-tf", "mlp"), ("rpgd-tf", "residual"), ("gradient-tf", "gp")]


@pytest.mark.parametrize("optimizer,model", FLEETS)
def test_results_do_not_depend_on_b(specs, optimizer, model):  # noqa: F811
    """Slots 0-1 of a 4-slot fleet and of a 2-slot fleet, over three ticks
    (a resample tick first) with a per-slot target (and pole length): the
    same controls."""
    spec = spec_of(specs, model)
    c4, c2 = fleet(spec, 4, optimizer, model), fleet(spec, 2, optimizer, model)
    for c in (c4, c2):
        c.update_slot_attributes(0, {"target_position": 0.2})
        if model in ("ode", "residual"):
            c.update_slot_dyn(1, {"L": 0.6})
    s = states(4)
    for _ in range(3):
        u4, u2 = c4.step_batch(s), c2.step_batch(s[:2])
        np.testing.assert_allclose(u2, u4[:2], atol=1e-6)
        s = s + 0.01


@pytest.mark.parametrize("optimizer", ["rpgd-tf", "gradient-tf"])
def test_a_slot_matches_a_single_mpc_controller(optimizer):
    """Slot 2 of a 3-slot ODE fleet against a single ``mpc`` controller
    started from the slot's generator, over 12 ticks (RPGD: two resample
    ticks): the controls."""
    batched = fleet("ODE", 3, optimizer, per_slot_dyn=())
    single = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                           config={"optimizer": optimizer, "device": "cpu",
                                   "controller_logging": False})
    single.configure(optimizer_name=optimizer, optimizer_config=grad_config(optimizer),
                     cost_function_config=COST_WEIGHTS)
    single.optimizer.opt_state = single.optimizer._init_state(batched._slot_generator(2))
    s = np.array([0.1, 0.0, 0.2, -0.1], np.float32)
    for _ in range(12):
        u_b = batched.step_batch(np.tile(s, (3, 1)))
        np.testing.assert_allclose(u_b[2], single.step(s), atol=2e-5)
        s = s + 0.01


def snapshot(ctrl, i: int) -> list:
    st = ctrl.slot_states
    return [st.generator[i].get_state(), st.Q[i].clone(), st.adam.m[i].clone(),
            st.adam.v[i].clone(), int(st.adam.step[i]), int(st.count[i]), st.u_prev[i].clone()] \
        + ([st.trajectory_ages[i].clone()] if hasattr(st, "trajectory_ages") else [])


def same(a: list, b: list) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


@pytest.mark.parametrize("optimizer", ["rpgd-tf", "gradient-tf"])
def test_mask_freezes_a_slot_bit_for_bit(optimizer):
    """A frozen slot keeps its population, Adam moments and step, counter,
    ages and generator bit for bit (over a resample tick), and commands 0;
    the active slots move."""
    ctrl = fleet("ODE", 4, optimizer)
    s = states(4)
    ctrl.step_batch(s)
    mask = np.array([True, False, True, False])
    for _ in range(10):  # RPGD's next resample tick is the 10th
        before = {i: snapshot(ctrl, i) for i in range(4)}
        u = ctrl.step_batch(s, mask)
        assert np.all(u[~mask] == 0.0)
        for i in range(4):
            assert same(before[i], snapshot(ctrl, i)) == (not mask[i])


@pytest.mark.parametrize("optimizer", ["rpgd-tf", "gradient-tf"])
def test_reset_slot_and_nan_guard_touch_one_slot(optimizer):
    """``reset_slot(1)`` gives slot 1 its first tick's state and leaves the
    others; a slot whose population turned NaN commands 0 and is reset
    alone."""
    ctrl = fleet("ODE", 4, optimizer)
    s = states(4)
    ctrl.step_batch(s)
    kept = {i: snapshot(ctrl, i) for i in (0, 2, 3)}
    ctrl.reset_slot(1)
    fresh = ctrl.optimizer._init_state(ctrl._slot_generator(1))
    assert torch.equal(ctrl.slot_states.Q[1], fresh.Q)
    assert int(ctrl.slot_states.count[1]) == 0 and int(ctrl.slot_states.adam.step[1]) == 0
    assert torch.all(ctrl.slot_states.adam.m[1] == 0.0)
    assert all(same(kept[i], snapshot(ctrl, i)) for i in kept)

    poisoned = ctrl.slot_states.Q.clone()
    poisoned[2] = float("nan")
    ctrl.slot_states = ctrl.slot_states._replace(Q=poisoned)
    u = ctrl.step_batch(s)
    assert u[2] == 0.0 and np.all(np.isfinite(u))
    assert torch.isfinite(ctrl.slot_states.Q).all()
    assert list(ctrl.slot_states.count) == [2, 1, 0, 2]  # slot 1 was reset before the tick


GRAD_GATES = ("_batched_rpgd_eligible", "_batched_gradient_eligible")
OTHER_GATES = ("_batched_kernel_eligible", "_batched_fused_cem_eligible",
               "_batched_neural_eligible", "_batched_recurrent_eligible",
               "_batched_residual_eligible", "_batched_gp_eligible")


@pytest.mark.parametrize("optimizer", ["rpgd-tf", "rpgd-particle-tf", "gradient-tf"])
@pytest.mark.parametrize("model", MODELS)
def test_gates_choose_each_gradient_step(specs, optimizer, model):  # noqa: F811
    """Exactly the optimizer's gradient gate admits the fleet over each model
    (an MLP fleet at K=32 too: the JAX gate's K >= 128 is a TPU choice), and
    the step it built launches the model's forms: on the CPU their plain
    versions."""
    ctrl = fleet(spec_of(specs, model), 2, optimizer, model)
    admitted = {g for g in GRAD_GATES + OTHER_GATES if getattr(ctrl, g)()}
    assert admitted == {GRAD_GATES[optimizer == "gradient-tf"]}
    assert ctrl.optimizer._grad_kernel_model_ok(bool(per_slot_dyn(model)))
    u = ctrl.step_batch(states(2))
    assert u.shape == (2, 1) and np.all(np.isfinite(u))


@pytest.mark.parametrize("kind", ["warmup_rpgd", "warmup_gradient", "recurrent", "force_scan",
                                  "value_terminal", "cem_modular", "cem_warmup"])
def test_what_the_gradient_fleets_leave_out_is_refused(specs, kind):  # noqa: F811
    """Warmup (one Adam trip count for all sessions), a recurrent net, a
    user's force_scan, modular CEM and a post-terminal hook that is not a
    plain tanh-MLP V (which the session-row value_spec forms take:
    tests/test_torch_value_grad.py) take the JAX package's vmapped per-slot
    step: the controller raises NotImplementedError naming the piece; the
    steps' own refusals are the JAX package's."""
    if kind == "value_terminal":
        ctrl = fleet("ODE", 2)
        cf = ctrl.optimizer.cost_function.cost_function
        cf.post_terminal_cost = lambda x, params: x[:, 0]
        assert not ctrl._batched_rpgd_eligible()
        assert "vmapped per-slot" in str(ctrl._refusal())
        with pytest.raises(NotImplementedError, match="vmapped per-slot"):
            ctrl.optimizer._make_batched_rpgd_step(2)
        return
    if kind == "cem_warmup":
        opt = make_pair("cem-tf", "ODE", dict(CEM_CONFIG, warmup=True))[1].optimizer
        with pytest.raises(NotImplementedError, match="warmup"):
            opt._make_batched_cem_step(2)
        return
    build, match = {
        "warmup_rpgd": (lambda: fleet("ODE", 2, warmup=True), "warmup"),
        "warmup_gradient": (lambda: fleet("ODE", 2, "gradient-tf", warmup=True), "warmup"),
        "recurrent": (lambda: fleet(specs["gru"], 2, model="gru"), "vmapped"),
        "force_scan": (lambda: fleet("ODE", 2, force_scan=True), "vmapped"),
        "cem_modular": (lambda: BatchedMPCController(
            "cartpole", LIMITS, {"target_position": 0.0},
            config={"optimizer": "cem-tf", "device": "cpu", "controller_logging": False},
        ).configure(optimizer_name="cem-tf", optimizer_config=CEM_CONFIG,
                    cost_function_config=COST_WEIGHTS, num_slots=2), "modular CEM"),
    }[kind]
    with pytest.raises(NotImplementedError, match=match):
        build()


@pytest.mark.parametrize("model", ["mlp", "gp", "gru"])
def test_binder_refuses_what_the_jax_binder_refuses(specs, model):  # noqa: F811
    """Per-slot dynamics over a net or a GP, and a recurrent net: the JAX
    binder's ValueErrors; warmup: its NotImplementedError."""
    _, pctrl = make_pair("rpgd-tf", specs[model], grad_config("rpgd-tf"))
    opt = pctrl.optimizer
    if model == "gru":
        with pytest.raises(ValueError, match="recurrent predictors"):
            opt._make_batched_rpgd_step(2)
        return
    with pytest.raises(ValueError, match="per-slot dynamics require an ODE predictor"):
        opt._make_batched_rpgd_step(2, per_slot_dyn=("L",))
    opt.warmup = True
    with pytest.raises(NotImplementedError, match="warmup=False"):
        opt._make_batched_rpgd_step(2)


def test_slot_states_carry_across_from_numpy():
    gens = tuple(torch.Generator().manual_seed(i) for i in range(2))
    z = np.zeros((2, 4, H, 1), np.float32)
    st = rpgd_slot_states_from_numpy(z, z, z, [1, 2], np.zeros((2, 4)), [3, 4], np.zeros((2, 1)),
                                     gens)
    assert st.generator == gens and st.Q.dtype == torch.float32
    assert list(st.adam.step) == [1, 2] and list(st.count) == [3, 4]
    gst = gradient_slot_states_from_numpy(z, z, z, [5, 6], [7, 8], np.zeros((2, 1)), gens)
    assert list(gst.adam.step) == [5, 6] and tuple(gst.Q.shape) == (2, 4, H, 1)


# ---- on the card ------------------------------------------------------------
SINGLE_KERNELS = {"k1": cost_rollout, "k7": grad_cost_rollout, "k8": neural_grad_cost_rollout,
                  "k9": residual_grad_cost_rollout, "k10": gp_grad_cost_rollout}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
def test_cuda_cols_forms_match_plain_versions(specs, cuda_device, form):  # noqa: F811
    """Each form against its plain version on the same card tensors, 3
    sessions of 100 rollouts (blocks, adjoint blocks and 16-rollout groups
    straddle sessions), within chip_smoke.py's bound for its kernel (the
    GP's well-conditioned), and equal per session to its single-session
    kernel."""
    from chip_smoke import DQ_ATOL_FRAC, DQ_RTOL, KERNEL_TOL, NET_TOL, close, well_conditioned_gp

    pctrl = form_pair(specs, form, 100)
    if form == "k10":
        pred = pctrl.optimizer.predictor.predictor
        pred.gp_params = well_conditioned_gp(pred.gp_params)
    cols, cols_plain, _ = FORMS[form]
    args = form_problem(form, pctrl, 3, 100, device=cuda_device)
    got, ref = cols(*args), cols_plain(*args)
    per_session = [SINGLE_KERNELS[form](*single_args(args, b)) for b in range(3)]
    torch.cuda.synchronize()
    tol = NET_TOL if form in ("k8", "k9") else KERNEL_TOL
    if form == "k1":
        torch.testing.assert_close(got, ref, **tol)
        assert torch.equal(got, torch.stack(per_session))
        return
    torch.testing.assert_close(got[0], ref[0], **tol)
    assert close(got[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC)
    assert torch.equal(got[0], torch.stack([c for c, _ in per_session]))
    assert torch.equal(got[1], torch.cat([d for _, d in per_session]))
