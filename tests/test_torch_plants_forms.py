"""The learned-value and residual forms over the pendulum, acrobot,
point-mass, quadrotor, car and arm plants (plant ids 2-17) against the JAX
package: the ``emit_terminal`` forms of K1, K2 and K4, K7's ``value_spec``
forms, and K12 and K9 over every ODE base, with the steps that run them.

Each form's plain version is held, for every plant id (the fast plants
through ``":fast"`` predictors), to the JAX kernel the JAX package builds
for it, in interpret mode (B=2 sessions, H=8): K1's emit form and K7's
value form to the optimizer's ``_build_pallas_cost`` / ``_build_pallas_grad``
under a learned value terminal, their session-row forms to the kernels the
JAX batched binder builds (``batched_kernels`` captured, one tile of B*K);
K2's emit form to ``make_run.external(K, emit_terminal=True)`` and K4's to
``make_run.cols(B*K, emit_terminal=True)``; K12 and K9, plain and valued,
single-session and session-row, to ``_build_pallas_residual_cost`` /
``_build_pallas_residual_grad`` and the residual binder's kernels over a
``ResidualPredictor`` of the plant with a seeded nonzero residual.  V is a
seeded tanh MLP of the plant's S states (``jax_value_net``).  One update of
each path (valued semi-fused and modular MPPI, valued rpgd-tf, MPPI and
rpgd-tf over ``"ODE+res"``, and the four fleets) is held to the JAX
package's step over the pendulum, the point mass under obstacles, the 3-D
quadrotor (S=12, U=4: the residual MLP's two lane tiles) and car/obstacles,
fed the JAX draws.

Tolerances, each with its reason: the ODE forms' costs to
tests/test_torch_plants.py's COST_TOL and dQ to its GRAD_TOL (float32 sums
over 8 rk4 steps in another order; V's products summed in another order),
x_H to test_torch_value.py's STATE_TOL; the residual forms to
test_torch_residual.py's COST_TOL and GRAD_TOL (the JAX residual kernel
tests' own bounds: the MLP's matmuls sum in other orders); the steps to the
bounds of the cartpole tests they follow (test_torch_mppi.py,
test_torch_rpgd.py, test_torch_fleet.py, test_torch_fleet_grad.py), the
``"ODE+res"`` fleet's Adam moments to RES_MOMENT_TOL (see there).  On a
machine with a card every plant's instance of each form is held to its
plain version (``-m cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops.common import AdamState as JaxAdamState
from control_toolkit_tpu.ops.pallas_mppi import ROWS
from control_toolkit_tpu.optimizers import kernel_families as jkf
from control_toolkit_tpu.optimizers.base import make_slot_packer as jax_slot_packer
from control_toolkit_tpu.optimizers.kernel_families.batched import (
    bind_batched_grad_kernels as jax_bind_batched,
)
from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
from control_toolkit_tpu.optimizers.rpgd import RPGDState as JaxRPGDState
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout_cols_emit, cost_rollout_cols_emit_plain, cost_rollout_emit,
    cost_rollout_emit_plain,
)
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_cols, grad_cost_rollout_cols_plain,
    grad_cost_rollout_cols_value, grad_cost_rollout_plain, grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost, mppi_cost_emit, mppi_cost_emit_plain
from control_toolkit_tpu_torch.ops.mppi_cost_cols import (
    eps_from_tiles, mppi_cost_cols, mppi_cost_cols_emit, mppi_cost_cols_emit_plain,
    xterm_from_tiles,
)
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (
    residual_grad_cost_rollout, residual_grad_cost_rollout_cols,
    residual_grad_cost_rollout_cols_plain, residual_grad_cost_rollout_cols_value,
    residual_grad_cost_rollout_plain, residual_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.residual_rollout import (
    residual_cost_rollout, residual_cost_rollout_cols, residual_cost_rollout_cols_emit,
    residual_cost_rollout_cols_emit_plain, residual_cost_rollout_emit,
    residual_cost_rollout_emit_plain, residual_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.kernel_families import ode, residual
from control_toolkit_tpu_torch.optimizers.mppi import MPPIState
from control_toolkit_tpu_torch.utils.convert import (
    mppi_slot_states_from_numpy, mppi_state_from_numpy, params_from_numpy,
    rpgd_slot_states_from_numpy, rpgd_state_from_numpy,
)
from test_torch_fleet import UNOM_TOL as FLEET_UNOM_TOL
from test_torch_fleet_grad import ADAM_STEPS
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, COST_TOL, UNOM_TOL, jax_next_draw, jax_params_numpy, port_noise
from test_torch_plants import (
    DIMS, GRAD_TOL, PLANTS, controls, label_of, limits, make_pair, mppi_config, rpgd_config,
    states,
)
from test_torch_plants_fleets import FLEET_LABELS, RPGD_COUNTS, SLOT_DYN
from test_torch_residual import COST_TOL as RES_COST_TOL
from test_torch_residual import GRAD_TOL as RES_GRAD_TOL
from test_torch_residual import bench_residual
from test_torch_rpgd import MOMENT_TOL, Q_TOL, jax_rpgd_draw
from test_torch_value import STATE_TOL, attach_both, jax_value_net

B, HF = 2, 8
# Rollouts a session of the single-session and session-row forms (the
# 3-D quadrotor's gradient kernels through jax.vjp in interpret mode are
# the slow case: 16 there), and of K2's single-tile emit form.
KS, KS_QUAD3D, K2_K, K2_TILE = 32, 16, 128, 128
PLANT_IDS = [p for p in kernels.PLANT_IDS if p not in kernels.CARTPOLE_PLANTS]
# The 14 forms this file holds, by the KERNEL_PLANTS entry each carries.
FORMS = ("K1's emit_terminal form", "K1's session-row emit_terminal form",
         "K2's emit_terminal form", "K4's emit_terminal form", "K7's value_spec form",
         "K7's session-row value_spec form", "K9", "K9's value_spec form",
         "K9's session-row form", "K9's session-row value_spec form", "K12",
         "K12's emit_terminal form", "K12's session-row form",
         "K12's session-row emit_terminal form")
VALUE_SCALE = 2.0
# The residual's weights: bench_residual's 0.02-scaled normals times
# RES_SCALE, so that over H=8 steps it moves the costs well past the
# residual forms' bound.
RES_SCALE = 10.0
# The fleets' Adam moments, (1 - beta1) and (1 - beta2) times dQ (and its
# square) plus the held ones: over the ODE to test_torch_rpgd.py's
# MOMENT_TOL, over "ODE+res" to the rtol of the residual forms' dQ bound
# (RES_GRAD_TOL: K9's MLP products sum in another order than JAX's), its
# absolute part MOMENT_TOL's.
RES_MOMENT_TOL = dict(rtol=RES_GRAD_TOL["rtol"], atol=MOMENT_TOL["atol"])


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def spec_of(plant: str, res: bool) -> str:
    base = "ODE+res" if res else "ODE"
    return f"{base}:rk4:1:fast" if plant.endswith("_fast") else base


def ks_of(plant: str) -> int:
    return KS_QUAD3D if plant.startswith("quadrotor3d") else KS


def forms_pair(plant: str, optimizer: str, cfg: dict, res: bool = False,
               valued: bool = True, seed: int = 3):
    """The JAX and port ``mpc`` controllers over ``plant`` (its fast plant
    through a ``":fast"`` predictor), with the same nonzero residual
    (``res``: ``"ODE+res"``) and the same seeded value net of the plant's S
    (``valued``) in both; and the JAX params in both forms."""
    label = label_of(plant)
    jctrl, pctrl = make_pair(label, optimizer, cfg, spec_of(plant, res))
    if res:
        jpred = jctrl.optimizer.predictor.predictor
        weights = {k: RES_SCALE * v if k.startswith("w") else v
                   for k, v in bench_residual(jpred._res, seed=seed + 8).items()}
        jpred.set_residual(weights)
        jctrl._dyn_params = None
        pctrl.optimizer.predictor.predictor.set_residual(weights)
    if valued:
        S = DIMS[PLANTS[label][0]][0]
        attach_both(jctrl, pctrl, jax_value_net(seed, hiddens=(8,), S=S), scale=VALUE_SCALE)
    tree = jax_params_numpy(jctrl)
    return (jctrl, pctrl, jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(tree, CPU))


def single_inputs(plant: str, Kc: int, seed: int):
    """One session's tiled start state, controls and previous control."""
    env = PLANTS[label_of(plant)][0]
    U = DIMS[env][1]
    rng = np.random.default_rng(seed)
    s_tiled = np.repeat(states(label_of(plant), rng, 1), Kc, axis=0)
    return s_tiled, controls(env, rng, (Kc, HF, U), 0.8), controls(env, rng, (U,), 0.5)


def raw_emit(opt):
    """Leave the value hook out of ``opt``'s cost kernel: its family then
    returns the emit_terminal form's raw ``(cost, x_H)``."""
    opt._finalize_cost_kernel = lambda raw_call, post: raw_call


def sessions(plant: str, jparams, seed: int, n: int = B) -> dict:
    """Per-session operands made with numpy: states ``s [n, 1, S]``,
    previous controls, targets moved by up to 0.2, and the plant's slot
    constant (``SLOT_DYN``) over 0.9-1.1 of its default (the residual's in
    its base)."""
    label = label_of(plant)
    env = PLANTS[label][0]
    rng = np.random.default_rng(seed)
    key = SLOT_DYN[env]
    dyn = jparams["dyn"].get("base", jparams["dyn"])
    attrs = {k: (np.full(n, v, np.float32)
                 + (rng.uniform(-0.2, 0.2, n).astype(np.float32) if k.startswith("target")
                    else 0.0)).astype(np.float32)
             for k, v in PLANTS[label][3].items()}
    return {"s": states(label, rng, n)[:, None], "u_prev": controls(env, rng, (n, DIMS[env][1])),
            "slot": (float(dyn[key]) * np.linspace(0.9, 1.1, n)).astype(np.float32),
            "attrs": attrs, "key": key}


def with_slot(dyn: dict, x: dict, as_array) -> dict:
    """``dyn`` with the sessions' slot constant, at the top (an ODE) or in
    the residual's base."""
    if "base" in dyn:
        return dict(dyn, base=dict(dyn["base"], **{x["key"]: as_array(x["slot"])}))
    return dict(dyn, **{x["key"]: as_array(x["slot"])})


def jax_args(x: dict, jparams) -> tuple:
    return (jnp.asarray(x["s"]), with_slot(jparams["dyn"], x, jnp.asarray), jparams["cost"],
            {k: jnp.asarray(v) for k, v in x["attrs"].items()})


def port_args(x: dict, params) -> tuple:
    return (torch.tensor(x["s"]), with_slot(params["dyn"], x, torch.tensor), params["cost"],
            {k: torch.tensor(v) for k, v in x["attrs"].items()})


def port_rows(popt, model, x: dict, params) -> torch.Tensor:
    """The sessions' packed rows ``pvec_b [n, N]`` the port's fleets build
    (the residual's from its base's constants)."""
    _, slot_keys = split_slot_keys(model.param_keys, (x["key"],))
    _, dyn, cost, attrs = port_args(x, params)
    cf = popt.cost_function.cost_function
    return make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, len(x["slot"]), CPU)(
        torch.tensor(x["u_prev"]), dyn.get("base", dyn), cost, attrs)


def jax_cols_kernels(monkeypatch, jopt, family: str, n: int, Kc: int, key: str) -> tuple:
    """``(gkernel, ckernel, extra_ops, pack)``: the session-row kernels the
    JAX batched binder builds for ``jopt`` (interpret mode, one tile of
    n*K), captured from its family's ``batched_kernels``."""
    fam, got = getattr(jkf, family), {}
    build = fam.batched_kernels

    def grab(*a, **kw):
        got["kernels"] = build(*a, **kw)
        return got["kernels"]

    monkeypatch.setattr(fam, "batched_kernels", grab)
    _, _, pack = jax_bind_batched(jopt, n, tile_k=n * Kc, per_slot_dyn=(key,), interpret=True)
    return (*got["kernels"], pack)


def cols_inputs(plant: str, x: dict, Kc: int, seed: int):
    """The sessions' start states repeated over their rollouts and the
    controls ``Q [n*K, H, U]``."""
    env = PLANTS[label_of(plant)][0]
    rng = np.random.default_rng(seed)
    n, U = len(x["slot"]), DIMS[env][1]
    return np.repeat(x["s"][:, 0], Kc, axis=0), controls(env, rng, (n * Kc, HF, U), 0.8)


# ---- each form's plain version against the JAX kernel --------------------------------------
@pytest.mark.parametrize("plant", PLANT_IDS)
def test_k1_emit_and_k7_value_forms_match_pallas_interpret(monkeypatch, plant):
    """K1's emit_terminal form (costs and x_H) and K7's value_spec form (J
    and dQ with V in both) against the JAX kernels of a valued rpgd-tf
    optimizer, then their session-row forms against the kernels its batched
    binder builds, B sessions under their own rows."""
    Kc = ks_of(plant)
    jctrl, pctrl, jparams, params = forms_pair(plant, "rpgd-tf",
                                               rpgd_config(num_rollouts=Kc, mpc_horizon=HF))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    assert model.plant == plant and popt._value_grad_spec() == {"n_layers": 2}
    S = kernels.PLANT_DIMS[plant][0]
    s_tiled, Q, u_prev = single_inputs(plant, Kc, 1)
    jargs = tuple(map(jnp.asarray, (s_tiled, Q, u_prev)))
    pargs = tuple(map(torch.tensor, (s_tiled, Q, u_prev)))
    ref_cost, ref_dq = jopt._build_pallas_grad(interpret=True, tile_k=Kc)(*jargs, jparams)
    before = grad_cost_rollout_value.launches
    cost, dq = ode.build_grad(popt)(*pargs, params)
    assert grad_cost_rollout_value.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **GRAD_TOL)
    unvalued = grad_cost_rollout(model, pargs[0], pargs[1], pack(params, pargs[2]))[1]
    assert not np.allclose(unvalued.numpy(), np.asarray(ref_dq), **GRAD_TOL)  # dV/dx_H seeds
    raw_emit(jopt)
    raw_emit(popt)
    ref_cost, ref_x = jopt._build_pallas_cost(interpret=True, tile_k=Kc)(*jargs, jparams)
    cost, x_h = ode.build_cost(popt)(*pargs, params)
    assert x_h.shape == (Kc, S)
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(x_h.numpy(), np.asarray(ref_x), **STATE_TOL)
    assert torch.equal(x_h, cost_rollout_emit_plain(model, pargs[0], pargs[1],
                                                    pack(params, pargs[2]))[1])

    x = sessions(plant, jparams, 7)
    gkernel, ckernel, extra_ops, jpack = jax_cols_kernels(monkeypatch, jopt, "ode", B, Kc,
                                                          x["key"])
    s0, Qc = cols_inputs(plant, x, Kc, 8)
    pvec, pslot = jpack(jnp.asarray(x["u_prev"]), *jax_args(x, jparams)[1:])
    jd = jax_args(x, jparams)[1]
    cargs = (jnp.asarray(s0), jnp.asarray(Qc), pvec, pslot, *extra_ops(jd))
    ref_cost, ref_dq = gkernel(*cargs, *jopt._flatten_value_ops({"cost": jparams["cost"]}))
    args = (model, torch.tensor(s0), torch.tensor(Qc), port_rows(popt, model, x, params))
    cost, dq = grad_cost_rollout_cols_value(*args, popt._flatten_value_ops(params))
    assert cost.shape == (B, Kc)
    np.testing.assert_allclose(cost.numpy().reshape(-1), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **GRAD_TOL)
    ref_c, ref_x = ckernel(*cargs)
    c, xh = cost_rollout_cols_emit(*args)
    assert xh.shape == (B, Kc, S)
    np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref_c), **COST_TOL)
    np.testing.assert_allclose(xh.numpy().reshape(-1, S), np.asarray(ref_x), **STATE_TOL)


@pytest.mark.parametrize("plant", PLANT_IDS)
def test_k2_and_k4_emit_forms_match_pallas_interpret(plant):
    """K2's emit_terminal form against ``make_run.external(K,
    emit_terminal=True)`` (the tiles' rollout t*tile + r*C + c is the
    port's rollout k) and K4's against ``make_run.cols(B*K,
    emit_terminal=True)`` (x_H through ``xterm_from_tiles``): costs, x_H,
    and the emit forms' costs equal to the unvalued kernels'."""
    jctrl, pctrl, jparams, params = forms_pair(
        plant, "mppi", mppi_config(num_rollouts=K2_K, mpc_horizon=HF))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = ode.rollout_model(popt)
    env = PLANTS[label_of(plant)][0]
    S, U = DIMS[env]
    P = jopt.interp.number_of_interpolation_inducing_points
    rng = np.random.default_rng(5)
    _, jpack, _ = jopt._build_fused_mppi(interpret=True, tile_k=K2_TILE, build_step=False)
    run = jopt._last_fused_make_run.external(K2_K, emit_terminal=True)
    T, C = K2_K // K2_TILE, K2_TILE // ROWS
    eps_tiles = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
    s0 = states(label_of(plant), rng, 1)[0]
    u_nom, u_prev = controls(env, rng, (HF, U), 0.4), controls(env, rng, (U,), 0.5)
    costs2d, xterm = run(jnp.asarray(s0), jnp.asarray(u_nom), jpack(jparams, jnp.asarray(u_prev)),
                         jnp.asarray(eps_tiles))
    ref = np.asarray(costs2d).reshape(ROWS, T, C).transpose(1, 0, 2).reshape(K2_K)
    ref_x = np.asarray(xterm).reshape(S, ROWS, T, C).transpose(2, 1, 3, 0).reshape(K2_K, S)
    eps = eps_tiles.reshape(T, U, P, ROWS, C).transpose(2, 1, 0, 3, 4).reshape(P, U, K2_K)
    lo, hi = popt.action_low, popt.action_high
    args = (model, torch.tensor(s0), torch.tensor(u_nom), pack(params, torch.tensor(u_prev)),
            torch.tensor(eps), popt.interp.matrix, lo, hi, popt.cc_weight, popt.R, popt.NU)
    cost, x_h = mppi_cost_emit(*args)
    np.testing.assert_allclose(cost.numpy(), ref, **COST_TOL)
    np.testing.assert_allclose(x_h.numpy(), ref_x, **STATE_TOL)
    assert torch.equal(cost, mppi_cost(*args))

    Kc = 64
    x = sessions(plant, jparams, 9)
    _, _, make_run = jopt._build_fused_mppi(build_step=False, interpret=True, tile_k=Kc,
                                            slot_extra_keys=(f"d_{x['key']}",))
    cf = jopt.cost_function.cost_function
    pvec, rows = jax_slot_packer(make_run.shared_keys, make_run.slot_keys, cf.attr_defaults, B)(
        jnp.asarray(x["u_prev"]), *jax_args(x, jparams)[1:])
    u_nom = controls(env, rng, (B, HF, U), 0.4)
    T, C, cps = (B * Kc) // Kc, Kc // ROWS, Kc // ROWS
    eps = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)

    def expand(vals):
        return jnp.repeat(vals, cps, axis=0).reshape(T, C, vals.shape[1]).transpose(0, 2, 1)

    costs2d, xterm = make_run.cols(B * Kc, emit_terminal=True)(
        pvec, expand(jnp.asarray(x["s"][:, 0])),
        expand(jnp.asarray(u_nom.transpose(0, 2, 1).reshape(B, -1))), expand(rows),
        jnp.asarray(eps))
    ref = np.asarray(costs2d).reshape(ROWS, B, cps).transpose(1, 0, 2).reshape(B, Kc)
    args = (model, torch.tensor(x["s"][:, 0]), torch.tensor(u_nom),
            port_rows(popt, model, x, params), eps_from_tiles(torch.tensor(eps), B),
            popt.interp.matrix, lo, hi, popt.cc_weight, popt.R, popt.NU)
    cost, x_h = mppi_cost_cols_emit(*args)
    assert cost.shape == (B, Kc) and x_h.shape == (B, Kc, S)
    np.testing.assert_allclose(cost.numpy(), ref, **COST_TOL)
    np.testing.assert_allclose(x_h.numpy(),
                               xterm_from_tiles(torch.tensor(np.asarray(xterm)), B).numpy(),
                               **STATE_TOL)
    assert torch.equal(cost, mppi_cost_cols(*args))


@pytest.mark.parametrize("valued", [False, True], ids=["plain", "valued"])
@pytest.mark.parametrize("plant", PLANT_IDS)
def test_k12_and_k9_forms_match_pallas_interpret(monkeypatch, plant, valued):
    """K12 (valued: its emit_terminal form's costs and x_H) and K9 (valued:
    its value_spec form) over the plant as an ``"ODE+res"`` base against
    the JAX residual kernels, single-session and session-row (B sessions,
    each under its own base constant), with the seeded residual moving the
    costs off the base's."""
    Kc = ks_of(plant)
    jctrl, pctrl, jparams, params = forms_pair(
        plant, "rpgd-tf", rpgd_config(num_rollouts=Kc, mpc_horizon=HF), res=True, valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = residual.residual_model(popt)
    assert model.plant == plant and residual.can_use_grad(popt)
    S = kernels.PLANT_DIMS[plant][0]
    net = params["dyn"]["res"]
    assert net["w0"].shape[0] == S + kernels.PLANT_DIMS[plant][1]
    s_tiled, Q, u_prev = single_inputs(plant, Kc, 2)
    jargs = tuple(map(jnp.asarray, (s_tiled, Q, u_prev)))
    pargs = tuple(map(torch.tensor, (s_tiled, Q, u_prev)))
    grad_form = residual_grad_cost_rollout_value if valued else residual_grad_cost_rollout
    ref_cost, ref_dq = jopt._build_pallas_residual_grad(interpret=True, tile_k=Kc)(*jargs,
                                                                                   jparams)
    before = grad_form.launches
    cost, dq = residual.build_grad(popt)(*pargs, params)
    assert grad_form.launches == before
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **RES_COST_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **RES_GRAD_TOL)
    if valued:
        raw_emit(jopt)
        raw_emit(popt)
    ref = jopt._build_pallas_residual_cost(interpret=True, tile_k=Kc)(*jargs, jparams)
    got = residual.build_cost(popt)(*pargs, params)
    pvec = pack(params, pargs[2])
    if valued:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **RES_COST_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **STATE_TOL)
        assert torch.equal(got[0], residual_cost_rollout_plain(model, *pargs[:2], pvec, net))
        got = got[0]
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **RES_COST_TOL)
    base = residual_cost_rollout_plain(model, *pargs[:2], pvec,
                                       {k: torch.zeros_like(v) for k, v in net.items()})
    assert not np.allclose(got.numpy(), base.numpy(), **RES_COST_TOL)  # the residual counts

    x = sessions(plant, jparams, 10)
    gkernel, ckernel, extra_ops, jpack = jax_cols_kernels(monkeypatch, jopt, "residual", B, Kc,
                                                          x["key"])
    s0, Qc = cols_inputs(plant, x, Kc, 11)
    jd = jax_args(x, jparams)[1]
    pvec_j, pslot = jpack(jnp.asarray(x["u_prev"]), jd, jparams["cost"],
                          jax_args(x, jparams)[3])
    cargs = (jnp.asarray(s0), jnp.asarray(Qc), pvec_j, pslot, *extra_ops(jd))
    vops = jopt._flatten_value_ops({"cost": jparams["cost"]}) if valued else ()
    ref_cost, ref_dq = gkernel(*cargs, *vops)
    args = (model, torch.tensor(s0), torch.tensor(Qc), port_rows(popt, model, x, params), net)
    if valued:
        cost, dq = residual_grad_cost_rollout_cols_value(*args, popt._flatten_value_ops(params))
    else:
        cost, dq = residual_grad_cost_rollout_cols(*args)
    assert cost.shape == (B, Kc)
    np.testing.assert_allclose(cost.numpy().reshape(-1), np.asarray(ref_cost), **RES_COST_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **RES_GRAD_TOL)
    ref = ckernel(*cargs)
    if valued:
        c, xh = residual_cost_rollout_cols_emit(*args)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref[0]), **RES_COST_TOL)
        np.testing.assert_allclose(xh.numpy().reshape(-1, S), np.asarray(ref[1]), **STATE_TOL)
    else:
        c = residual_cost_rollout_cols(*args)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref), **RES_COST_TOL)


# ---- one update of each path against the JAX step ---------------------------------------
def set_mppi_state(jopt, popt, seed=0):
    rng = np.random.default_rng(seed)
    Hm, U = jopt.mpc_horizon, jopt.num_control_inputs
    lo, hi = popt.action_low.numpy(), popt.action_high.numpy()
    u_nom = rng.uniform(0.75 * lo + 0.25 * hi, 0.25 * lo + 0.75 * hi,
                        (1, Hm, U)).astype(np.float32)
    u_prev = np.full(U, 0.2, np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_nom=jnp.asarray(u_nom), u_prev=jnp.asarray(u_prev))
    popt.opt_state = mppi_state_from_numpy(u_nom, u_prev, popt.opt_state.generator)


def mppi_update(label, extra, res, valued):
    """One MPPI update fed the JAX step's noise: the new plan and control."""
    jctrl, pctrl, _, params = forms_pair(label, "mppi", mppi_config(mpc_horizon=HF, **extra),
                                         res=res, valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert popt._uses_semi_fused() == (not res and not extra)
    set_mppi_state(jopt, popt)
    s = states(label, np.random.default_rng(9), 1)[0]
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    u, _, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                             port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


def rpgd_update(label, res, valued):
    """One rpgd-tf update on a resample tick fed the JAX draw: J, the
    population, the Adam moments and the control."""
    jctrl, pctrl, _, params = forms_pair(label, "rpgd-tf", rpgd_config(mpc_horizon=HF), res=res,
                                         valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert (residual.can_use_grad if res else ode.can_use_grad)(popt)
    rng = np.random.default_rng(0)
    shape = (jopt.num_rollouts, jopt.mpc_horizon, jopt.num_control_inputs)
    Q = controls(PLANTS[label][0], rng, shape)
    m = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32)
    ages = rng.integers(0, 20, jopt.num_rollouts).astype(np.float32)
    u_prev = np.full(shape[2], 0.2, np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        Q=jnp.asarray(Q), adam=JaxAdamState(step=jnp.int32(4), m=jnp.asarray(m),
                                            v=jnp.asarray(v)),
        trajectory_ages=jnp.asarray(ages), count=jnp.int32(0), u_prev=jnp.asarray(u_prev))
    popt.opt_state = rpgd_state_from_numpy(Q, m, v, 4, ages, 0, u_prev, popt.opt_state.generator)
    s = states(label, rng, 1)[0]
    draw = torch.as_tensor(jax_rpgd_draw(jopt))
    u_jax = jctrl.step(s)
    u, state, _ = popt.update(popt.opt_state, torch.as_tensor(s)[None], params, draw)
    js = jopt.opt_state
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


def mppi_fleet_update(label, res, valued):
    """One batched MPPI update (valued: K4's emit form; ``"ODE+res"``:
    K12's session-row form) fed the JAX noise: costs and the new plans."""
    Kc = 64
    jctrl, pctrl, jparams, params = forms_pair(
        label, "mppi", mppi_config(num_rollouts=Kc, mpc_horizon=HF), res=res, valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 11)
    env = PLANTS[label][0]
    U = DIMS[env][1]
    psd = (x["key"],)
    rng = np.random.default_rng(12)
    u_nom = controls(env, rng, (B, 1, HF, U), 0.4)
    P = jopt.interp.number_of_interpolation_inducing_points
    jstates = JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32), u_nom=jnp.asarray(u_nom),
                           u_prev=jnp.asarray(x["u_prev"]))
    pstates = MPPIState(generator=(None,) * B, u_nom=torch.tensor(u_nom),
                        u_prev=torch.tensor(x["u_prev"]))
    if res:
        delta = (rng.standard_normal((B, Kc, P, U)) * jopt.SQRTRHODTINV).astype(np.float32)
        _, jupdate = jopt._make_batched_residual_step(B, interpret=True, tile_k=B * Kc,
                                                      per_slot_dyn=psd)
        _, update = popt._make_batched_residual_step(B, per_slot_dyn=psd)
        pstates = mppi_slot_states_from_numpy(u_nom, x["u_prev"], (None,) * B)
        noise_j, noise_p = jnp.asarray(delta), torch.tensor(delta)
    else:
        T, C = (B * Kc) // 128, 128 // ROWS
        eps = (rng.standard_normal((T, U, P * ROWS, C)) * jopt.SQRTRHODTINV).astype(np.float32)
        _, jupdate = jopt._make_batched_semi_fused_step(B, interpret=True, tile_k=128,
                                                        per_slot_dyn=psd)
        _, update = popt._make_batched_semi_fused_step(B, per_slot_dyn=psd)
        noise_j, noise_p = jnp.asarray(eps), eps_from_tiles(torch.tensor(eps), B)
    u_ref, c_ref = jupdate(jstates, *jax_args(x, jparams), noise_j)
    u_got, costs = update(pstates, *port_args(x, params), noise_p)
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **COST_TOL)
    np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref), **FLEET_UNOM_TOL)


def rpgd_fleet_update(label, res, valued):
    """One batched rpgd-tf update (K7's or K9's session-row form, valued:
    their value_spec forms) fed the JAX draw of the slot on its resample
    tick; the other slot keeps."""
    cfg = rpgd_config(num_rollouts=32, mpc_horizon=HF)
    jctrl, pctrl, jparams, params = forms_pair(label, "rpgd-tf", cfg, res=res, valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(label, jparams, 19)
    env = PLANTS[label][0]
    rng = np.random.default_rng(20)
    shape = (B, jopt.num_rollouts, HF, DIMS[env][1])
    p = {"Q": controls(env, rng, shape), "m": (0.05 * rng.standard_normal(shape)).astype(
        np.float32), "v": (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32),
         "ages": rng.integers(0, 20, shape[:2]).astype(np.float32)}
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(B)])
    psd, steps = (x["key"],), ADAM_STEPS[:B]
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
    dshape = (n, jopt.interp.number_of_interpolation_inducing_points, jopt.num_control_inputs)
    draws = [None if c % jopt.resamp_per else torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(keys[b])[1], dshape, minval=jopt.action_low, maxval=jopt.action_high)))
        for b, c in enumerate(RPGD_COUNTS)]
    pstates = rpgd_slot_states_from_numpy(p["Q"], p["m"], p["v"], steps, p["ages"],
                                          RPGD_COUNTS, x["u_prev"], (None,) * B)
    _, update = popt._make_batched_rpgd_step(B, per_slot_dyn=psd)
    u, new, costs = update(pstates, *port_args(x, params), draws)
    moment_tol = RES_MOMENT_TOL if res else MOMENT_TOL
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), **Q_TOL)
    np.testing.assert_allclose(new.Q.numpy(), np.asarray(jnew.Q), **Q_TOL)
    np.testing.assert_allclose(new.adam.m.numpy(), np.asarray(jnew.adam.m), **moment_tol)
    np.testing.assert_allclose(new.adam.v.numpy(), np.asarray(jnew.adam.v), **moment_tol)
    np.testing.assert_array_equal(new.adam.step, np.asarray(jnew.adam.step))
    np.testing.assert_array_equal(new.count, np.asarray(jnew.count))


# path: (the step, its keyword arguments, the forms it launches on a card)
PATHS = {
    "valued_mppi": (mppi_update, dict(extra={}, res=False, valued=True),
                    ("K2's emit_terminal form",)),
    "valued_modular_mppi": (mppi_update, dict(extra={"semi_fused": False}, res=False,
                                              valued=True), ("K1's emit_terminal form",)),
    "valued_rpgd": (rpgd_update, dict(res=False, valued=True),
                    ("K7's value_spec form", "K1's emit_terminal form")),
    "residual_mppi": (mppi_update, dict(extra={}, res=True, valued=False), ("K12",)),
    "residual_rpgd": (rpgd_update, dict(res=True, valued=False), ("K9", "K12")),
    "valued_mppi_fleet": (mppi_fleet_update, dict(res=False, valued=True),
                          ("K4's emit_terminal form",)),
    "valued_rpgd_fleet": (rpgd_fleet_update, dict(res=False, valued=True),
                          ("K7's session-row value_spec form",
                           "K1's session-row emit_terminal form")),
    "residual_mppi_fleet": (mppi_fleet_update, dict(res=True, valued=False),
                            ("K12's session-row form",)),
    "residual_rpgd_fleet": (rpgd_fleet_update, dict(res=True, valued=False),
                            ("K9's session-row form", "K12's session-row form")),
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("label", FLEET_LABELS)
def test_one_update_of_each_path_matches_jax(path, label):
    """One update of each path over the plant against the JAX package's
    step fed its draws (the forms it launches carry the plant)."""
    step, kwargs, forms = PATHS[path]
    assert all(label in kernels.KERNEL_PLANTS[form] for form in forms)
    step(label, **kwargs)


def test_the_forms_carry_every_plant_and_the_network_forms_refuse_them():
    """The 14 forms carry all 18 plant ids; the 23 network forms (K8's six,
    K10's, K11's, K13's and K14's 17) carry the ten cost plants (a network
    kernel's plant is its cost's, and no learned model has fast dynamics)
    and refuse every fast plant's id, naming the kernel and the plant."""
    for form in FORMS:
        assert set(kernels.KERNEL_PLANTS[form]) == set(kernels.PLANT_IDS), form
    network = [f for f in kernels.KERNEL_PLANTS if f.startswith(("K8", "K10", "K11", "K13",
                                                                  "K14"))]
    assert len(network) == 23 and not set(network) & set(FORMS)
    costs = {p for p in kernels.PLANT_IDS if p not in kernels.FAST_PLANTS.values()}
    assert set(kernels.COST_PLANTS) == costs and len(costs) == 10
    assert len([f for f in network if f.startswith("K8")]) == 6
    for form in network:
        assert set(kernels.KERNEL_PLANTS[form]) == costs, form
        kernels.require(form, "quadrotor3d")
        with pytest.raises(NotImplementedError, match=f"{form} over the 'quadrotor3d_fast'"):
            kernels.require(form, "quadrotor3d_fast")


# ---- on a card: every plant's instance of each form against its plain version -------------
def card_operands(plant: str, dev, res: bool):
    """A controller over the plant on the card, its model and pack, and
    seeded single-session and session-row operands (ragged: blocks and
    16-rollout groups straddle sessions)."""
    from test_torch_plants import port_ctrl

    label = label_of(plant)
    ctrl = port_ctrl(label, spec=spec_of(plant, res))
    popt = ctrl.optimizer
    if res:
        pred = popt.predictor.predictor
        gen = torch.Generator().manual_seed(11)
        pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen) if k.startswith("w")
                           else v for k, v in pred._res.items()})
    model, pack = (residual.residual_model if res else ode.rollout_model)(popt)
    assert model.plant == plant
    S, U = kernels.PLANT_DIMS[plant]
    gen = torch.Generator(device=dev).manual_seed(0)
    low, high = (torch.as_tensor(v, device=dev) for v in limits(PLANTS[label][0]))
    params = ctrl._assemble_params()
    Kc, Hc, Bc, ks = 700, 45, 3, 200
    pvec = pack(params, 0.5 * (low + high)).to(dev)
    rows = pvec.repeat(Bc, 1)
    rows[:, 0] *= torch.linspace(0.9, 1.1, Bc, device=dev)
    s0 = torch.as_tensor(states(label, np.random.default_rng(0), Kc), device=dev)
    Q = low + (high - low) * torch.rand(Kc, Hc, U, generator=gen, device=dev)
    sc = torch.as_tensor(states(label, np.random.default_rng(1), Bc),
                         device=dev).repeat_interleave(ks, 0)
    Qc = low + (high - low) * torch.rand(Bc * ks, Hc, U, generator=gen, device=dev)
    vg = torch.Generator(device=dev).manual_seed(S)
    vops = [t for d_in, d_out in ((S, 16), (16, 1))
            for t in (torch.randn(d_in, d_out, generator=vg, device=dev) / d_in ** 0.5,
                      0.1 * torch.randn(d_out, generator=vg, device=dev))]
    net = ({k: v.to(dev) for k, v in params["dyn"]["res"].items()} if res else None)
    return model, pvec, rows, s0, Q, sc, Qc, vops, net, (low, high), gen


def dq_close(got, ref):
    """test_torch_plants.py's K7 bound on dQ: 2e-5 of its largest entry."""
    return float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("plant", PLANT_IDS)
def test_cuda_form_instances_match_plain_versions(cuda_device, plant, form):  # noqa: F811
    """Each plant's instance of each form against its plain version on the
    same card tensors at ragged sizes (test_torch_kernels.py's tolerance;
    dQ to K7's bound; the residual forms to test_torch_residual.py's
    GRAD_TOL), the emit forms' costs equal to their kernels' and their x_H
    to STATE_TOL."""
    res = form.startswith(("K9", "K12"))
    model, pvec, rows, s0, Q, sc, Qc, vops, net, (lo, hi), gen = card_operands(
        plant, cuda_device, res)
    tol = dict(rtol=1e-4, atol=1e-3)
    if form == "K2's emit_terminal form":
        W = torch.as_tensor(interpolation_matrix(Q.shape[1], 10), device=lo.device)
        eps = 0.2 * torch.randn(W.shape[0], lo.shape[0], Q.shape[0], generator=gen,
                                device=lo.device)
        args = (model, s0[0].contiguous(), Q[0].contiguous(), pvec, eps, W, lo, hi, 1.0, 1.0,
                1000.0)
        (c, x), (rc, rx) = mppi_cost_emit(*args), mppi_cost_emit_plain(*args)
        assert torch.equal(c, mppi_cost(*args))
    elif form == "K4's emit_terminal form":
        Bc = rows.shape[0]
        W = torch.as_tensor(interpolation_matrix(Q.shape[1], 10), device=lo.device)
        eps = 0.2 * torch.randn(Bc, W.shape[0], lo.shape[0], 300, generator=gen,
                                device=lo.device)
        args = (model, sc[::sc.shape[0] // Bc].contiguous(), Qc[:Bc].contiguous(), rows, eps, W,
                lo, hi, 1.0, 1.0, 1000.0)
        (c, x), (rc, rx) = mppi_cost_cols_emit(*args), mppi_cost_cols_emit_plain(*args)
        assert torch.equal(c, mppi_cost_cols(*args))
    elif form == "K1's emit_terminal form":
        (c, x), (rc, rx) = cost_rollout_emit(model, s0, Q, pvec), cost_rollout_emit_plain(
            model, s0, Q, pvec)
    elif form == "K1's session-row emit_terminal form":
        (c, x), (rc, rx) = (cost_rollout_cols_emit(model, sc, Qc, rows),
                            cost_rollout_cols_emit_plain(model, sc, Qc, rows))
    elif form in ("K7's value_spec form", "K7's session-row value_spec form"):
        single = form == "K7's value_spec form"
        args = (model, s0, Q, pvec) if single else (model, sc, Qc, rows)
        got = (grad_cost_rollout_value if single else grad_cost_rollout_cols_value)(*args, vops)
        ref = (grad_cost_rollout_plain if single else grad_cost_rollout_cols_plain)(
            *args, value_ops=vops)
        torch.testing.assert_close(got[0], ref[0], **tol)
        assert dq_close(got[1], ref[1])
        unvalued = (grad_cost_rollout if single else grad_cost_rollout_cols)(*args)[1]
        assert not dq_close(unvalued, ref[1])  # dV/dx_H dropped from the seed
        return
    elif form.startswith("K9"):
        single, valued = "session-row" not in form, "value_spec" in form
        args = (model, s0, Q, pvec, net) if single else (model, sc, Qc, rows, net)
        kernel = {(True, False): residual_grad_cost_rollout,
                  (True, True): residual_grad_cost_rollout_value,
                  (False, False): residual_grad_cost_rollout_cols,
                  (False, True): residual_grad_cost_rollout_cols_value}[single, valued]
        plain = residual_grad_cost_rollout_plain if single else residual_grad_cost_rollout_cols_plain
        got = kernel(*args, vops) if valued else kernel(*args)
        ref = plain(*args, value_ops=vops if valued else None)
        torch.testing.assert_close(got[0], ref[0], **tol)
        torch.testing.assert_close(got[1], ref[1], rtol=RES_GRAD_TOL["rtol"],
                                   atol=RES_GRAD_TOL["atol"])
        return
    else:  # K12's forms
        single, emit = "session-row" not in form, "emit" in form
        args = (model, s0, Q, pvec, net) if single else (model, sc, Qc, rows, net)
        kernel = residual_cost_rollout if single else residual_cost_rollout_cols
        plain = residual_cost_rollout_emit_plain if single else residual_cost_rollout_cols_emit_plain
        rc, rx = plain(*args)
        if not emit:
            torch.testing.assert_close(kernel(*args), rc, **tol)
            return
        c, x = (residual_cost_rollout_emit if single else residual_cost_rollout_cols_emit)(*args)
        assert torch.equal(c, kernel(*args))
    torch.testing.assert_close(c, rc, **tol)
    torch.testing.assert_close(x, rx, rtol=1e-4, atol=1e-4 * (1.0 + float(rx.abs().max())))
