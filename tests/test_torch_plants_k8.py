"""K8, the MLP gradient kernel, over the pendulum, acrobot, point-mass,
quadrotor, car and arm costs against the JAX package: its six forms (plain,
value_spec, member-block and its value_spec form, session-row and its
value_spec form) and the paths that run them.

K8's plant is its cost's (the dynamics are the net's tensors), so each of
the nine costs other than cartpole's is an instance of each form.  Each
form's plain version is held, for every cost, to the JAX kernel the JAX
package builds for it, in interpret mode (H=8): the optimizer's
``_build_pallas_neural_grad`` and ``_build_pallas_ensemble_grad`` (the
value_spec forms under a seeded value net of the plant's S), and the
session-row kernels captured from the JAX batched binder (B=2 sessions of
32 rollouts, each its own target and previous control).  The nets are
test_torch_plants_nets.py's: an MLP 16-16 with norms and two members of
mlp-16-16, seeded with numpy at the plant's widths, written by the JAX
package's own ``save_net`` and read by both packages.  The plain versions
stay generic over the cost (``model.stage``, ``model.terminal`` and the
cost's adjoints): K8's plain J is K11's plain cost, and its dQ
``torch.autograd`` of K11's plain version, in float64.  One update of each
path K8 opens over the costs (rpgd-tf over the MLP, valued and not, and over
the ensemble; gradient-tf, cem-grad-bharadhwaj and one mppi-optimize-tf
step over the MLP; the rpgd-tf fleet over the MLP) is held to the JAX
package's step fed its draws over the pendulum, pointmass/obstacles, the
3-D quadrotor (S=12, U=4: two lane tiles each way on the card) and arm2.

Tolerances, each with its reason: J and dQ to test_torch_neural_grad.py's
COST_TOL and GRAD_TOL (the member-block forms to test_torch_ensemble.py's,
the same numbers): the JAX kernel's matmuls sum in another order; the
autograd check to 1e-9 in float64; the steps to the bounds of the cartpole
tests they follow (test_torch_rpgd.py's Q_TOL and MOMENT_TOL,
test_torch_cem_grad.py's UNOM_TOL, test_torch_mppi.py's UNOM_TOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops import common as jcommon
from control_toolkit_tpu.optimizers import kernel_families as jkf
from control_toolkit_tpu.optimizers.kernel_families.batched import (
    bind_batched_grad_kernels as jax_bind_batched,
)
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.common import AdamState
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
    neural_grad_cost_rollout_cols_value, neural_grad_cost_rollout_ens,
    neural_grad_cost_rollout_ens_plain, neural_grad_cost_rollout_ens_value,
    neural_grad_cost_rollout_plain, neural_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.neural_rollout import neural_cost_rollout_plain
from control_toolkit_tpu_torch.optimizers.cem import cem_trip_count
from control_toolkit_tpu_torch.optimizers.cem_grad_bharadhwaj import CEMGradState
from control_toolkit_tpu_torch.optimizers.kernel_families import ensemble, neural
from control_toolkit_tpu_torch.utils.convert import (
    gradient_state_from_numpy, rpgd_state_from_numpy,
)
from test_torch_cem_grad import UNOM_TOL as CEM_UNOM_TOL
from test_torch_ensemble import COST_TOL as ENS_COST_TOL
from test_torch_ensemble import GRAD_TOL as ENS_GRAD_TOL
from test_torch_mppi import UNOM_TOL, jax_next_draw, port_noise
from test_torch_mppi_optimize import no_autograd
from test_torch_neural_grad import COST_TOL, GRAD_TOL
from test_torch_plants import DIMS, PLANTS, controls, mppi_config, rpgd_config, states
from test_torch_plants_nets import (
    COSTS, ENS_MEMBERS, HF, KS, nets_pair, port_rows, rpgd_fleet_update,
    sessions, set_mppi_state, single_inputs, specs,  # noqa: F401  (specs: fixture)
)
from test_torch_rpgd import MOMENT_TOL, Q_TOL, jax_resample_key, jax_rpgd_draw

# The costs each newly opened path's update is held over.
PATH_COSTS = ("pendulum", "pointmass_obstacles", "quadrotor3d", "arm2")
# K8's six forms (the KERNEL_PLANTS entries).
K8_FORMS = ("K8", "K8's value_spec form", "K8's member-block form",
            "K8's member-block value_spec form", "K8's session-row form",
            "K8's session-row value_spec form")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def as64(tree):
    """A tensor, or a dict or list of them, in float64."""
    if isinstance(tree, dict):
        return {k: as64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as64(v) for v in tree]
    return tree.double()


def assert_close(got: torch.Tensor, ref, tol: dict) -> float:
    """``got`` against the JAX kernel's ``ref``; returns the largest error."""
    got, ref = got.numpy().reshape(np.shape(ref)), np.asarray(ref)
    np.testing.assert_allclose(got, ref, **tol)
    return float(np.abs(got - ref).max())


def jax_cols_kernel(monkeypatch, jopt):
    """``(gkernel, pack)``: the session-row gradient kernel the JAX batched
    binder builds over the MLP (interpret mode, one tile of B*K) and its
    packing."""
    fam, got = jkf.neural, {}
    build = fam.batched_kernels

    def grab(*a, **kw):
        got["kernels"] = build(*a, **kw)
        return got["kernels"]

    monkeypatch.setattr(fam, "batched_kernels", grab)
    _, _, pack = jax_bind_batched(jopt, 2, tile_k=2 * KS, per_slot_dyn=(), interpret=True)
    gkernel, _, extra_ops = got["kernels"][:3]
    return gkernel, extra_ops, pack


# ---- each form's plain version against the JAX kernel (interpret mode) ---------------------
@pytest.mark.parametrize("valued", [False, True], ids=["plain", "value"])
@pytest.mark.parametrize("plant", COSTS)
def test_k8_and_session_row_forms_match_pallas_interpret(monkeypatch, specs, plant,  # noqa: F811
                                                         valued):
    """K8 (valued: its value_spec form) over the cost, single-session
    against ``_build_pallas_neural_grad``, then its session-row form (B
    sessions, each its own target and previous control) against the kernel
    the JAX batched binder builds: J and dQ; V moves dQ.  Unvalued, the
    plain version's J is K11's plain cost and its dQ autograd through it
    in float64 (the cost's own stage, terminal and adjoints)."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, "mlp", "rpgd-tf",
                                              rpgd_config(num_rollouts=KS, mpc_horizon=HF),
                                              valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = neural.net_model(popt)
    assert model.plant == plant and neural.can_use_grad(popt)
    assert (popt._value_grad_spec() is not None) == valued
    jargs, pargs = single_inputs(plant, KS, 6)
    ref_cost, ref_dq = jopt._build_pallas_neural_grad(interpret=True, tile_k=KS)(*jargs, jparams)
    wrapper = neural_grad_cost_rollout_value if valued else neural_grad_cost_rollout
    before = wrapper.launches
    cost, dq = neural.build_grad(popt)(*pargs, params)
    assert wrapper.launches == before  # CPU tensors: the plain version
    assert_close(cost, ref_cost, COST_TOL)
    err = assert_close(dq, ref_dq, GRAD_TOL)
    pvec, net = pack(params, pargs[2]), params["dyn"]["net"]
    if valued:  # dV/dx_H seeds the backward: dropping it moves dQ 10x past the error
        unvalued = neural_grad_cost_rollout_plain(model, *pargs[:2], pvec, net)[1]
        assert np.abs(unvalued.numpy() - np.asarray(ref_dq)).max() > 10 * err
    else:
        s0, Q, pv, n64 = as64([pargs[0], pargs[1], pvec, net])
        c64, d64 = neural_grad_cost_rollout_plain(model, s0, Q, pv, n64)
        with torch.enable_grad():
            Qv = Q.clone().requires_grad_(True)
            k11 = neural_cost_rollout_plain(model, s0, Qv, pv, n64)
            (auto,) = torch.autograd.grad(k11.sum(), Qv)
        torch.testing.assert_close(c64, k11.detach(), rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(d64, auto, rtol=1e-9, atol=1e-9)

    gkernel, extra_ops, jpack = jax_cols_kernel(monkeypatch, jopt)
    x = sessions(plant, 7, KS)
    pvec_j, pslot = jpack(jnp.asarray(x["u_prev"]), jparams["dyn"], jparams["cost"],
                          {k: jnp.asarray(v) for k, v in x["attrs"].items()})
    vops = jopt._flatten_value_ops({"cost": jparams["cost"]}) if valued else ()
    ref_cost, ref_dq = gkernel(jnp.asarray(x["s0"]), jnp.asarray(x["Q"]), pvec_j, pslot,
                               *extra_ops(jparams["dyn"]), *vops)
    args = (model, torch.tensor(x["s0"]), torch.tensor(x["Q"]), port_rows(popt, model, x, params),
            net)
    wrapper = neural_grad_cost_rollout_cols_value if valued else neural_grad_cost_rollout_cols
    before = wrapper.launches
    if valued:
        cost, dq = wrapper(*args, popt._flatten_value_ops(params))
    else:
        cost, dq = wrapper(*args)
        assert torch.equal(dq, neural_grad_cost_rollout_cols_plain(*args)[1])
    assert wrapper.launches == before
    assert cost.shape == (2, KS)
    assert_close(cost, ref_cost, COST_TOL)
    assert_close(dq, ref_dq, GRAD_TOL)


@pytest.mark.parametrize("valued", [False, True], ids=["plain", "value"])
@pytest.mark.parametrize("plant", COSTS)
def test_k8_member_block_forms_match_pallas_interpret(specs, plant, valued):  # noqa: F811
    """K8's member-block form (valued: its value_spec form, every member
    under one V) over the cost and two stacked members, against
    ``_build_pallas_ensemble_grad``: rollout k under member k // (K/E); J
    and dQ, the plain version autograd through K11's member-block one."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, "ensemble", "rpgd-tf",
                                              rpgd_config(num_rollouts=KS, mpc_horizon=HF),
                                              valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = ensemble.net_model(popt)
    assert model.plant == plant and ensemble.can_use_grad(popt)
    assert (popt._value_grad_spec() is not None) == valued
    jargs, pargs = single_inputs(plant, KS, 8)
    ref_cost, ref_dq = jopt._build_pallas_ensemble_grad(
        interpret=True, tile_k=KS // ENS_MEMBERS)(*jargs, jparams)
    wrapper = neural_grad_cost_rollout_ens_value if valued else neural_grad_cost_rollout_ens
    before = wrapper.launches
    cost, dq = ensemble.build_grad(popt)(*pargs, params)
    assert wrapper.launches == before
    assert_close(cost, ref_cost, ENS_COST_TOL)
    err = assert_close(dq, ref_dq, ENS_GRAD_TOL)
    pvec, net = pack(params, pargs[2]), params["dyn"]["net"]
    plain = neural_grad_cost_rollout_ens_plain(model, *pargs[:2], pvec, net)
    if valued:
        assert np.abs(plain[1].numpy() - np.asarray(ref_dq)).max() > 10 * err
    else:
        assert torch.equal(dq, plain[1])


# ---- one update of each newly opened path against the JAX step ------------------------------
def rpgd_update(specs, plant, kind, valued=False):  # noqa: F811
    """One rpgd-tf update on a resample tick fed the JAX draw (K8, or its
    member-block form, at outer_its Adam steps): the population, the Adam
    moments and the control."""
    jctrl, pctrl, _, params = nets_pair(specs, plant, kind, "rpgd-tf",
                                        rpgd_config(num_rollouts=KS, mpc_horizon=HF),
                                        valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    fam = ensemble if kind == "ensemble" else neural
    assert fam.can_use_grad(popt) and (popt._value_grad_spec() is not None) == valued
    st = population(jopt, plant, 0)
    ages = np.random.default_rng(1).integers(0, 20, jopt.num_rollouts).astype(np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        Q=jnp.asarray(st["Q"]), adam=jax_adam(st), trajectory_ages=jnp.asarray(ages),
        count=jnp.int32(0), u_prev=jnp.asarray(st["u_prev"]))
    popt.opt_state = rpgd_state_from_numpy(st["Q"], st["m"], st["v"], 4, ages, 0, st["u_prev"],
                                           popt.opt_state.generator)
    s = states(plant, np.random.default_rng(2), 1)[0]
    draw = torch.as_tensor(jax_rpgd_draw(jopt))
    u_jax = jctrl.step(s)
    u, state, _ = popt.update(popt.opt_state, torch.as_tensor(s)[None], params, draw)
    js = jopt.opt_state
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


def population(jopt, plant: str, seed: int) -> dict:
    """A seeded population within the plant's limits, Adam moments and a
    previous control."""
    rng = np.random.default_rng(seed)
    env = PLANTS[plant][0]
    shape = (jopt.num_rollouts, jopt.mpc_horizon, jopt.num_control_inputs)
    return {"Q": controls(env, rng, shape),
            "m": (0.05 * rng.standard_normal(shape)).astype(np.float32),
            "v": (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32),
            "u_prev": controls(env, rng, shape[2:], 0.4)}


def jax_adam(st: dict):
    return jcommon.AdamState(step=jnp.int32(4), m=jnp.asarray(st["m"]), v=jnp.asarray(st["v"]))


def gradient_update(specs, plant):  # noqa: F811
    """One gradient-tf update over the MLP (gradient_steps K8 launches), the
    JAX step's fresh tail fed to the port: the population, the moments and
    the control."""
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": HF, "num_rollouts": KS,
           "gradient_steps": 3, "learning_rate": 0.05, "gradmax_clip": 5,
           "warmup_iterations": 4}
    jctrl, pctrl, _, params = nets_pair(specs, plant, "mlp", "gradient-tf", cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert neural.can_use_grad(popt)
    st = population(jopt, plant, 4)
    jopt.opt_state = jopt.opt_state._replace(Q=jnp.asarray(st["Q"]), adam=jax_adam(st),
                                             count=jnp.int32(5), u_prev=jnp.asarray(st["u_prev"]))
    popt.opt_state = gradient_state_from_numpy(st["Q"], st["m"], st["v"], 4, 5, st["u_prev"],
                                               popt.opt_state.generator)
    U = jopt.num_control_inputs
    tail = np.array(jax.random.uniform(jax_resample_key(jopt), (jopt.num_rollouts, 1, U),
                                       minval=jopt.action_low, maxval=jopt.action_high,
                                       dtype=jnp.float32))
    s = states(plant, np.random.default_rng(5), 1)[0]
    u_jax = jctrl.step(s)
    u, state, _ = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                              torch.as_tensor(tail))
    js = jopt.opt_state
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(state.adam.v.numpy(), np.asarray(js.adam.v), **MOMENT_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


def bharadhwaj_update(specs, plant):  # noqa: F811
    """One cem-grad-bharadhwaj update over the MLP (an Adam step through K8
    each iteration) from a nontrivial distribution and Adam state, fed the
    elite seed's and each iteration's normals: the plan, the refit
    distribution and the moments."""
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": HF, "num_rollouts": 64,
           "cem_outer_it": 2, "cem_initial_action_stdev": 2.0, "cem_stdev_min": 1e-6,
           "cem_best_k": 8, "learning_rate": 0.05, "adam_beta_1": 0.9, "adam_beta_2": 0.999,
           "adam_epsilon": 1e-8, "gradmax_clip": 5, "warmup": False, "warmup_iterations": 3}
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, "mlp", "cem-grad-bharadhwaj-tf", cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert neural.can_use_grad(popt)
    env = PLANTS[plant][0]
    U = DIMS[env][1]
    rng = np.random.default_rng(6)
    mue = controls(env, rng, (1, HF, U), 0.4)
    std = rng.uniform(0.2, 0.6, (1, HF, U)).astype(np.float32)
    u_prev = controls(env, rng, (U,), 0.4)
    m = (0.05 * rng.standard_normal((64, HF, U))).astype(np.float32)
    v = (0.01 * rng.uniform(0.1, 1.0, (64, HF, U))).astype(np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std),
        adam=jcommon.AdamState(step=jnp.int32(4), m=jnp.asarray(m), v=jnp.asarray(v)),
        count=jnp.int32(3), u_prev=jnp.asarray(u_prev))
    popt.opt_state = CEMGradState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std),
                                  AdamState(4, torch.tensor(m), torch.tensor(v)), 3,
                                  torch.tensor(u_prev))
    its = cem_trip_count(popt, 3)
    key, sub = jax.random.split(jopt.opt_state.key)
    draws = [torch.tensor(np.asarray(jax.random.normal(sub, (8, HF, U), jnp.float32)))]
    for _ in range(its):
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(np.asarray(jax.random.normal(sub, (56, HF, U), jnp.float32))))
    assert [t.shape for t in popt.sample_draws(popt.opt_state)] == [t.shape for t in draws]
    s = states(plant, np.random.default_rng(7), 1)[0]
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(diag_j["u_nom"]),
                               **CEM_UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **CEM_UNOM_TOL)
    for name in ("dist_mue", "stdev"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **CEM_UNOM_TOL, err_msg=name)
    np.testing.assert_allclose(st.adam.m.numpy(), np.asarray(st_j.adam.m), **CEM_UNOM_TOL)


def mppi_optimize_update(specs, plant, monkeypatch):  # noqa: F811
    """One mppi-optimize-tf step over the MLP (the modular MPPI update over
    K11, then two Adam steps on the nominal plan's cost through K8 at one
    rollout, never torch.autograd) fed the JAX step's noise: the refined
    plan and the control."""
    cfg = mppi_config(num_rollouts=64, mpc_horizon=HF, optim_steps=2, mppi_LR=0.05,
                      adam_beta_1=0.4, adam_beta_2=0.8, adam_epsilon=1e-7, gradmax_clip=1000.0)
    jctrl, pctrl, _, params = nets_pair(specs, plant, "mlp", "mppi-optimize-tf", cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert neural.can_use_grad(popt) and popt.optim_steps == jopt.optim_steps == 2
    set_mppi_state(jopt, popt)
    s = states(plant, np.random.default_rng(9), 1)[0]
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    no_autograd(monkeypatch)
    u, _, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                             port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom),
                               **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


# path: (the step, the forms it launches on a card)
PATHS = {
    "rpgd_mlp": (lambda sp, p, mp: rpgd_update(sp, p, "mlp"), ("K8",)),
    "valued_rpgd_mlp": (lambda sp, p, mp: rpgd_update(sp, p, "mlp", valued=True),
                        ("K8's value_spec form",)),
    "rpgd_ensemble": (lambda sp, p, mp: rpgd_update(sp, p, "ensemble"),
                      ("K8's member-block form",)),
    "gradient_mlp": (lambda sp, p, mp: gradient_update(sp, p), ("K8",)),
    "bharadhwaj_mlp": (lambda sp, p, mp: bharadhwaj_update(sp, p), ("K8",)),
    "mppi_optimize_mlp": (lambda sp, p, mp: mppi_optimize_update(sp, p, mp), ("K8",)),
    "rpgd_fleet_mlp": (lambda sp, p, mp: rpgd_fleet_update(sp, p, "mlp"),
                       ("K8's session-row form",)),
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("plant", PATH_COSTS)
def test_one_update_of_each_k8_path_matches_jax(monkeypatch, specs, path, plant):  # noqa: F811
    """One update of each path K8 opens over the cost against the JAX
    package's step fed its draws (the forms it launches carry the cost)."""
    step, forms = PATHS[path]
    assert all(plant in kernels.KERNEL_PLANTS[form] for form in forms)
    step(specs, plant, monkeypatch)


def test_k8_forms_carry_the_costs_and_refuse_the_fast_plants():
    """K8's six forms carry the ten cost plants and refuse every fast
    plant's id (no learned model has fast dynamics), naming the kernel and
    the plant; the plain versions stay generic over the cost's model (a
    cost's stage scaled moves K8's plain J as it moves K11's)."""
    costs = set(kernels.PLANT_IDS) - set(kernels.FAST_PLANTS.values())
    for form in K8_FORMS:
        assert kernels.KERNEL_PLANTS[form] == kernels.COST_PLANTS
        assert set(kernels.KERNEL_PLANTS[form]) == costs
        for plant in costs:
            kernels.require(form, plant)
        for fast in kernels.FAST_PLANTS.values():
            with pytest.raises(NotImplementedError, match=f"{form} over the '{fast}'"):
                kernels.require(form, fast)
    rng = np.random.default_rng(0)
    S, U = kernels.PLANT_DIMS["arm2"]
    net = {"w0": torch.tensor(0.3 * rng.standard_normal((S + U, 8)), dtype=torch.float32),
           "b0": torch.zeros(8), "w1": torch.tensor(0.3 * rng.standard_normal((8, S)),
                                                     dtype=torch.float32), "b1": torch.zeros(S)}
    model = kernels.NetModel(plant="arm2", param_keys=kernels.COST_PARAM_KEYS["arm2"],
                             stage=lambda xs, us, prev, p: xs[0] * xs[0] + us[0] * us[1],
                             terminal=lambda xs, p: xs[1] * xs[1], max_cost=1e9, kind="mlp",
                             predict_delta=True)
    s0 = torch.tensor(rng.uniform(-0.5, 0.5, (6, S)), dtype=torch.float32)
    Q = torch.tensor(rng.uniform(-1, 1, (6, 3, U)), dtype=torch.float32)
    pvec = torch.zeros(len(model.param_keys))
    doubled = dataclasses.replace(model, stage=lambda *a: 2.0 * model.stage(*a))
    for m in (model, doubled):
        torch.testing.assert_close(neural_grad_cost_rollout_plain(m, s0, Q, pvec, net)[0],
                                   neural_cost_rollout_plain(m, s0, Q, pvec, net))
