"""The port's learned value terminal in the gradient kernels over the learned
dynamics and in the gradient fleets, against the JAX package.

The ``value_spec`` forms of K8 (and of its member-block form), K9 and K10,
their session-row (``slot_keys``) forms, K7's session-row value form and
K1's session-row ``emit_terminal`` form: each form's plain version (the
wrapper on CPU tensors) is held to the JAX gradient or cost kernel built
with V in it, in interpret mode: the single-session forms through each
optimizer's own builder (``_build_pallas_*_grad``) over a JAX-initialised
``mlp-16-16`` with norms, ``"ODE+res"`` with a nonzero residual, a small
GP the JAX package fits and the committed four-member ensemble; the
session-row forms through the kernels the JAX package's batched binder
builds (``kernel_families/batched.py:bind_batched_grad_kernels``, its
family's ``batched_kernels`` captured, one tile of B*K), 3 sessions of 40
rollouts (16-rollout groups straddle sessions) each with its own target,
previous control and, over the ODE and the residual, pole length.  V is a
seeded 4-8-8-1 net (JAX ``mlp_init``) at scale 3 and the committed
4-32-32-1 net (``value-mlp-32-32.npz``), whose slope (up to ~1e5 a unit
of state) turns float32 rounding in x_H into a cost and gradient
difference past the families' bounds: over it each output is held, as
chip_smoke.py holds the kernels over the committed GP (gp_vs_float64), to
the float64 plain version, no further from it than F64_FACTOR times the
JAX kernel's own distance from it plus 1e-6 of its largest entry.  Then
one valued rpgd-tf and one
gradient-tf update over the MLP, "ODE+res", the GP and the ensemble, and
one valued batched RPGD and gradient-tf update over the ODE (with and
without per-slot pole lengths), the MLP, "ODE+res" and the GP, each fed
the JAX draws and held to the JAX package's.

Tolerances, each the family's own: the MLP's COST_TOL and GRAD_TOL
(tests/test_torch_neural_grad.py:39-40), the residual's
(test_torch_residual.py:53-54), the GP's (test_torch_gp.py:66-67), the
ensemble's (test_torch_ensemble.py:71-72), K7's (test_torch_value.py:
COST_TOL, GRAD_TOL) for the ODE forms and the terminal states to
test_torch_value.py's STATE_TOL; the updates to test_torch_rpgd.py's
COST_TOL, Q_TOL and MOMENT_TOL (the GP's moments to
test_torch_fleet_grad.py's GP_MOMENT_TOL and its population to
test_torch_gp.py's tick bound), the fleets to test_torch_fleet_grad.py's.
On a machine with a card, each CUDA form is held to its plain version
(``-m cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu.ops.common import AdamState as JaxAdamState
from control_toolkit_tpu.optimizers import kernel_families as jkf
from control_toolkit_tpu.optimizers.gradient import GradientState as JaxGradientState
from control_toolkit_tpu.optimizers.kernel_families.batched import (
    bind_batched_grad_kernels as jax_bind_batched,
)
from control_toolkit_tpu.optimizers.rpgd import RPGDState as JaxRPGDState
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.cost_rollout import (
    cost_rollout_cols, cost_rollout_cols_emit, cost_rollout_cols_emit_plain, cost_rollout_emit,
)
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import (
    gp_grad_cost_rollout, gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_plain,
    gp_grad_cost_rollout_cols_value, gp_grad_cost_rollout_plain, gp_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.gp_rollout import flatten_gp_weights
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout_cols, grad_cost_rollout_cols_plain, grad_cost_rollout_cols_value,
    grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
    neural_grad_cost_rollout_cols_value, neural_grad_cost_rollout_ens,
    neural_grad_cost_rollout_ens_value, neural_grad_cost_rollout_ens_value_plain,
    neural_grad_cost_rollout_plain, neural_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (
    residual_grad_cost_rollout, residual_grad_cost_rollout_cols,
    residual_grad_cost_rollout_cols_plain, residual_grad_cost_rollout_cols_value,
    residual_grad_cost_rollout_plain, residual_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.kernel_families import ensemble, gp, neural, ode, residual
from control_toolkit_tpu_torch.utils.convert import (
    gradient_slot_states_from_numpy, gradient_state_from_numpy, params_from_numpy,
    rpgd_slot_states_from_numpy,
)
from test_torch_ensemble import COST_TOL as ENS_COST_TOL
from test_torch_ensemble import GRAD_TOL as ENS_GRAD_TOL
from test_torch_fleet_grad import (
    ADAM_STEPS, COUNTS, GP_MOMENT_TOL, assert_states_match, grad_config, jax_args,
    jax_rpgd_draws, population, port_args, slot_keys_jax, with_slot_dyn,
)
from test_torch_fleet_grad import B as FB
from test_torch_fleet_grad import KC as FKC
from test_torch_fleet_grad import make_pair as fleet_pair
from test_torch_fleet_learned import specs  # noqa: F401  (fixture)
from test_torch_gp import COST_TOL as GP_COST_TOL
from test_torch_gp import GRAD_TOL as GP_GRAD_TOL
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, LIMITS, jax_params_numpy
from test_torch_neural_grad import COST_TOL as MLP_COST_TOL
from test_torch_neural_grad import GRAD_TOL as MLP_GRAD_TOL
from test_torch_residual import COST_TOL as RES_COST_TOL
from test_torch_residual import GRAD_TOL as RES_GRAD_TOL
from test_torch_residual import bench_residual
from test_torch_rpgd import COST_TOL as UPDATE_COST_TOL
from test_torch_rpgd import (
    MOMENT_TOL, Q_TOL, gradient_config, jax_adam, jax_resample_key, jax_rpgd_draw, rpgd_config,
    set_rpgd_state, shared_population,
)
from test_torch_value import ASSETS, STATE_TOL, VALUE_FILE, attach_both, jax_value_net
from test_torch_value import COST_TOL as ODE_COST_TOL
from test_torch_value import GRAD_TOL as ODE_GRAD_TOL

K, H = 128, 8
ENS_SPEC = f"ensemble:mlp-32-32:4:{ASSETS}"
# kind: (the port's family, the JAX optimizer's builder of its gradient
# kernel, the JAX tile, (COST_TOL, GRAD_TOL), the port's value form).
SINGLE = {"mlp": (neural, "_build_pallas_neural_grad", 32, (MLP_COST_TOL, MLP_GRAD_TOL),
                  neural_grad_cost_rollout_value),
          "residual": (residual, "_build_pallas_residual_grad", 64, (RES_COST_TOL, RES_GRAD_TOL),
                       residual_grad_cost_rollout_value),
          "gp": (gp, "_build_pallas_gp_grad", 64, (GP_COST_TOL, GP_GRAD_TOL),
                 gp_grad_cost_rollout_value),
          "ensemble": (ensemble, "_build_pallas_ensemble_grad", 32, (ENS_COST_TOL, ENS_GRAD_TOL),
                       neural_grad_cost_rollout_ens_value)}
# kind: (the port's model and pack, the net's operands from params["dyn"]).
MODELS = {"mlp": (neural.net_model, lambda d: d["net"]),
          "ensemble": (ensemble.net_model, lambda d: d["net"]),
          "residual": (residual.residual_model, lambda d: d["res"]),
          "gp": (gp.gp_model, lambda d: flatten_gp_weights(d["gp"]))}
# kind: (the JAX family, the port's model, its session-row value form,
# (COST_TOL, GRAD_TOL), the per-slot dynamics).
COLS = {"ode": ("ode", lambda o: ode.rollout_model(o)[0], grad_cost_rollout_cols_value,
                (ODE_COST_TOL, ODE_GRAD_TOL), ("L",)),
        "mlp": ("neural", lambda o: neural.net_model(o)[0], neural_grad_cost_rollout_cols_value,
                (MLP_COST_TOL, MLP_GRAD_TOL), ()),
        "residual": ("residual", lambda o: residual.residual_model(o)[0],
                     residual_grad_cost_rollout_cols_value, (RES_COST_TOL, RES_GRAD_TOL), ("L",)),
        "gp": ("gp", lambda o: gp.gp_model(o)[0], gp_grad_cost_rollout_cols_value,
               (GP_COST_TOL, GP_GRAD_TOL), ())}
VALUES = ("seeded", "committed")
# chip_smoke.py's GP_F64_FACTOR.
F64_FACTOR = 2.0


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def value_net(which: str) -> tuple:
    """``(net as numpy, scale)``: the seeded 4-8-8-1 V at scale 3, or the
    committed 4-32-32-1 V at scale 1."""
    if which == "seeded":
        return jax_value_net(31, hiddens=(8, 8)), 3.0
    net, _ = jnets.load_net(ASSETS / VALUE_FILE)
    return jax.tree_util.tree_map(np.asarray, net), 1.0


def spec_of(specs, kind: str) -> str:  # noqa: F811
    return {"ode": "ODE", "ensemble": ENS_SPEC}.get(kind) or specs[kind]


def valued_pair(spec: str, optimizer: str, config: dict, which: str = "seeded",
                jax_logging: bool = False):
    """The JAX and the port ``mpc`` controller over ``spec`` (the residual
    with the same nonzero weights in both) with one V attached to both."""
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                   config={"optimizer": optimizer, "controller_logging": jax_logging})
    jctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(config))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": optimizer,
                                  "controller_logging": False})
    pctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                    optimizer_config=dict(config))
    if spec == "ODE+res":
        jpred = jctrl.optimizer.predictor.predictor
        res = bench_residual(jpred._res)
        jpred.set_residual(res)
        jctrl._dyn_params = None
        pctrl.optimizer.predictor.predictor.set_residual(res)
    net, scale = value_net(which)
    attach_both(jctrl, pctrl, net, scale)
    return jctrl, pctrl


def both_params(jctrl):
    tree = jax_params_numpy(jctrl)
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(tree, CPU))


def as64(t):
    """A tensor, a dict of them or a list of them in float64."""
    if isinstance(t, dict):
        return {k: as64(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [as64(v) for v in t]
    return t.double() if isinstance(t, torch.Tensor) else t


def assert_held(which: str, got: torch.Tensor, ref, ref64: torch.Tensor, tol: dict) -> None:
    """``got`` (the port's plain version in float32) against ``ref`` (the JAX
    kernel's): to ``tol`` under the seeded V; under the committed V no
    further from ``ref64`` (the port's plain version in float64) than
    F64_FACTOR times the JAX kernel's own distance from it, plus 1e-6 of
    its largest entry (see the module docstring)."""
    got, ref = got.numpy().reshape(np.shape(ref)), np.asarray(ref)
    if which == "seeded":
        np.testing.assert_allclose(got, ref, **tol)
        return
    ref64 = ref64.numpy().reshape(ref.shape)
    port_err = float(np.abs(got.astype(np.float64) - ref64).max())
    jax_err = float(np.abs(ref.astype(np.float64) - ref64).max())
    assert port_err <= F64_FACTOR * jax_err + 1e-6 * float(np.abs(ref64).max()), \
        (port_err, jax_err)


def inputs(seed: int, Kc: int = K, Hc: int = H):
    rng = np.random.default_rng(seed)
    s_tiled = np.tile(np.array([[0.1, -0.2, 0.3, 0.05]], np.float32), (Kc, 1))
    Q = rng.uniform(-0.8, 0.8, (Kc, Hc, 1)).astype(np.float32)
    return s_tiled, Q, np.array([0.25], np.float32)


# ---- the single-session value forms against the JAX kernels ----------------------------
@pytest.mark.parametrize("which", VALUES)
@pytest.mark.parametrize("kind", list(SINGLE))
def test_value_form_plain_matches_pallas_interpret(specs, kind, which):  # noqa: F811
    """K8's, K8-ens's, K9's and K10's value_spec form (its family's
    ``build_grad``: the wrapper on CPU tensors runs the plain version)
    against the JAX gradient kernel built with ``value_spec`` (interpret
    mode): J and dQ; V moved dQ."""
    fam, builder, tile, (cost_tol, grad_tol), form = SINGLE[kind]
    jctrl, pctrl = valued_pair(spec_of(specs, kind), "rpgd-tf",
                               rpgd_config(num_rollouts=K, mpc_horizon=H), which)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert fam.can_use_grad(popt) and popt._value_grad_spec() == jopt._value_grad_spec()
    jkernel = getattr(jopt, builder)(interpret=True, tile_k=tile)
    s_tiled, Q, u_prev = inputs(len(kind) + len(which))
    jparams, params = both_params(jctrl)
    ref_cost, ref_dq = jkernel(jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev), jparams)
    before = form.launches
    args = (torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev), params)
    cost, dq = fam.build_grad(popt)(*args)
    assert form.launches == before  # CPU tensors: the plain version
    make_model, weights = MODELS[kind]
    model, pack = make_model(popt)
    cost64, dq64 = form(model, *as64([args[0], args[1], pack(params, args[2])]),
                        as64(weights(params["dyn"])), as64(popt._flatten_value_ops(params)))
    assert_held(which, cost, ref_cost, cost64, cost_tol)
    assert_held(which, dq, ref_dq, dq64, grad_tol)
    no_value = dict(params, cost=dict(params["cost"], _value_scale=torch.tensor(0.0)))
    assert not torch.allclose(fam.build_grad(popt)(*args[:3], no_value)[1], dq, **grad_tol)


# ---- the session-row forms against the kernels of the JAX batched binder -----------------
def jax_cols_kernels(monkeypatch, jopt, family: str, B: int, Kc: int, per_slot: tuple):
    """``(gkernel, ckernel, extra_ops, pack)``: the session-row kernels the
    JAX binder builds for ``jopt`` (its ``value_spec`` gradient and
    ``emit_terminal`` cost kernels, interpret mode, one tile of B*K)."""
    fam, got = getattr(jkf, family), {}
    build = fam.batched_kernels

    def grab(*a, **kw):
        got["kernels"] = build(*a, **kw)
        return got["kernels"]

    monkeypatch.setattr(fam, "batched_kernels", grab)
    _, _, pack = jax_bind_batched(jopt, B, tile_k=B * Kc, per_slot_dyn=per_slot, interpret=True)
    return (*got["kernels"], pack)


def cols_problem(jctrl, kind: str, B: int, Kc: int, seed: int):
    """Per-session operands made with numpy, and each package's packed
    rows and dynamics: ``(s0, Q, (jdyn, jcost, jattrs, u_prev), (dyn,
    pvec_b))``."""
    _, model_of, _, _, per_slot = COLS[kind]
    rng = np.random.default_rng(seed)
    u_prev = rng.uniform(-0.5, 0.5, (B, 1)).astype(np.float32)
    target = np.linspace(-0.3, 0.3, B).astype(np.float32)
    L = np.linspace(0.35, 0.65, B).astype(np.float32)
    s0 = np.repeat(rng.uniform(-0.3, 0.3, (B, 4)).astype(np.float32), Kc, axis=0)
    Q = rng.uniform(-1.0, 1.0, (B * Kc, H, 1)).astype(np.float32)
    jparams, params = both_params(jctrl)
    jdyn = with_slot_dyn(jparams["dyn"], kind, jnp.asarray(L))
    dyn = with_slot_dyn(params["dyn"], kind, torch.tensor(L))
    return (s0, Q, u_prev, target, jdyn, jparams["cost"], dyn, params["cost"])


@pytest.mark.parametrize("which", VALUES)
@pytest.mark.parametrize("kind", list(COLS))
def test_session_row_value_forms_match_pallas_interpret(monkeypatch, specs, kind,  # noqa: F811
                                                        which):
    """K7's, K8's, K9's and K10's session-row value_spec forms (``slot_keys``
    + ``value_spec``) and, over the ODE, K1's session-row emit_terminal form
    (``slot_keys`` + ``emit_terminal``): 3 sessions of 40 rollouts against
    the JAX kernels its batched binder builds: J and dQ (the cost form's
    costs and x_H)."""
    family, model_of, form, (cost_tol, grad_tol), per_slot = COLS[kind]
    B, Kc = 3, 40
    jctrl, pctrl = valued_pair(spec_of(specs, kind), "rpgd-tf",
                               rpgd_config(num_rollouts=Kc, mpc_horizon=H), which)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    gkernel, ckernel, extra_ops, jpack = jax_cols_kernels(monkeypatch, jopt, family, B, Kc,
                                                          per_slot)
    s0, Q, u_prev, target, jdyn, jcost, dyn, cost = cols_problem(jctrl, kind, B, Kc, 7)
    pvec, pslot = jpack(jnp.asarray(u_prev), jdyn, jcost, {"target_position": jnp.asarray(target)})
    jargs = (jnp.asarray(s0), jnp.asarray(Q), pvec, pslot, *extra_ops(jdyn))
    ref_cost, ref_dq = gkernel(*jargs, *jopt._flatten_value_ops({"cost": jcost}))
    model = model_of(popt)
    _, slot_keys = split_slot_keys(model.param_keys, per_slot)
    leaves = dyn["base"] if kind == "residual" else dyn
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, CPU)(
        torch.tensor(u_prev), leaves, cost, {"target_position": torch.tensor(target)})
    weights = {"ode": (), "mlp": (dyn.get("net"),), "residual": (dyn.get("res"),),
               "gp": (flatten_gp_weights(dyn["gp"]) if kind == "gp" else None,)}[kind]
    args = (model, torch.tensor(s0), torch.tensor(Q), pvec_b, *weights)
    before = form.launches
    ops = popt._flatten_value_ops({"cost": cost})
    got_cost, got_dq = form(*args, ops)
    assert form.launches == before and got_cost.shape == (B, Kc)
    args64 = (model, *as64(args[1:]))
    cost64, dq64 = form(*args64, as64(ops))
    assert_held(which, got_cost, ref_cost, cost64, cost_tol)
    assert_held(which, got_dq, ref_dq, dq64, grad_tol)
    if kind == "ode":
        ref_c, ref_x = ckernel(*jargs)
        c, x = cost_rollout_cols_emit(*args)
        assert x.shape == (B, Kc, 4)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref_c), **cost_tol)
        np.testing.assert_allclose(x.numpy().reshape(-1, 4), np.asarray(ref_x), **STATE_TOL)


@pytest.mark.parametrize("kind", list(COLS))
def test_session_row_value_forms_are_the_single_session_forms_per_session(specs,  # noqa: F811
                                                                          kind):
    """Each session-row value form's plain version equals the single-session
    value form run with session b's row over its rollouts (the ODE's
    exactly, as its unvalued form), and K1's session-row emit form the
    single-session emit form."""
    _, model_of, form, _, _ = COLS[kind]
    B, Kc = 3, 40
    jctrl, pctrl = valued_pair(spec_of(specs, kind), "rpgd-tf",
                               rpgd_config(num_rollouts=Kc, mpc_horizon=H))
    popt = pctrl.optimizer
    s0, Q, u_prev, target, _, _, dyn, cost = cols_problem(jctrl, kind, B, Kc, 9)
    model = model_of(popt)
    _, slot_keys = split_slot_keys(model.param_keys, COLS[kind][4])
    leaves = dyn["base"] if kind == "residual" else dyn
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, CPU)(
        torch.tensor(u_prev), leaves, cost, {"target_position": torch.tensor(target)})
    weights = {"ode": (), "mlp": (dyn.get("net"),), "residual": (dyn.get("res"),),
               "gp": (flatten_gp_weights(dyn["gp"]) if kind == "gp" else None,)}[kind]
    ops = popt._flatten_value_ops({"cost": cost})
    single = {"ode": grad_cost_rollout_value, "mlp": neural_grad_cost_rollout_value,
              "residual": residual_grad_cost_rollout_value, "gp": gp_grad_cost_rollout_value}[kind]
    s0, Q = torch.tensor(s0), torch.tensor(Q)
    cost_b, dq_b = form(model, s0, Q, pvec_b, *weights, ops)
    tol = dict(rtol=0, atol=0) if kind == "ode" else dict(rtol=1e-6, atol=1e-5)
    for b in range(B):
        rows = slice(b * Kc, (b + 1) * Kc)
        c, d = single(model, s0[rows], Q[rows], pvec_b[b], *weights, ops)
        torch.testing.assert_close(cost_b[b], c, **tol)
        torch.testing.assert_close(dq_b[rows], d, **tol)
        if kind == "ode":
            ce, xe = cost_rollout_cols_emit(model, s0, Q, pvec_b)
            c1, x1 = cost_rollout_emit(model, s0[rows], Q[rows], pvec_b[b])
            assert torch.equal(ce[b], c1) and torch.equal(xe[b], x1)
            assert torch.equal(ce, cost_rollout_cols(model, s0, Q, pvec_b))


# ---- one valued update of each optimizer over each learned model -------------------------
def assert_update_matches(kind, jopt, state, diag, u, u_jax):
    """The population, moments, costs and control against the JAX step's:
    test_torch_rpgd.py's bounds, the GP's moments to GP_MOMENT_TOL and its
    population to test_torch_gp.py's tick bound."""
    js, jlog = jopt.opt_state, jopt.logging_values
    q_tol = dict(rtol=1e-3, atol=1e-4) if kind == "gp" else Q_TOL
    moment_tol = GP_MOMENT_TOL if kind == "gp" else MOMENT_TOL
    cost_tol = GP_COST_TOL if kind == "gp" else UPDATE_COST_TOL
    np.testing.assert_allclose(diag["J_logged"].numpy(), jlog["J_logged"], **cost_tol)
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **q_tol)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **moment_tol)
    np.testing.assert_allclose(state.adam.v.numpy(), np.asarray(js.adam.v), **moment_tol)
    assert state.count == int(js.count) and state.adam.step == int(js.adam.step)
    np.testing.assert_allclose(u.numpy(), u_jax, **q_tol)


@pytest.mark.parametrize("kind", list(SINGLE))
def test_one_valued_rpgd_update_matches_jax(specs, kind):  # noqa: F811
    """One rpgd-tf update with V on a resample tick, fed the JAX draw: the
    port's gradient is its family's value_spec form (the plain version), the
    JAX step's its kernel's (off a TPU, jax.grad through its scan with V
    in the terminal cost)."""
    fam, _, _, _, form = SINGLE[kind]
    jctrl, pctrl = valued_pair(spec_of(specs, kind), "rpgd-tf",
                               rpgd_config(num_rollouts=64, mpc_horizon=H), jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert fam.can_use_grad(popt)
    set_rpgd_state(jopt, popt, 10)
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    draw = torch.as_tensor(jax_rpgd_draw(jopt))
    params = both_params(jctrl)[1]
    u_jax = jctrl.step(s)
    before = form.launches
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params, draw)
    assert form.launches == before
    assert_update_matches(kind, jopt, state, diag, u, u_jax)


@pytest.mark.parametrize("kind", list(SINGLE))
def test_one_valued_gradient_update_matches_jax(specs, kind):  # noqa: F811
    """One gradient-tf update with V, the JAX step's tail fed to the port."""
    fam = SINGLE[kind][0]
    jctrl, pctrl = valued_pair(spec_of(specs, kind), "gradient-tf",
                               gradient_config(num_rollouts=64, mpc_horizon=H), jax_logging=True)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert fam.can_use_grad(popt)
    st = shared_population(jopt, seed=4)
    jopt.opt_state = jopt.opt_state._replace(Q=jnp.asarray(st["Q"]), adam=jax_adam(st),
                                             count=jnp.int32(5),
                                             u_prev=jnp.asarray(st["u_prev"]))
    popt.opt_state = gradient_state_from_numpy(st["Q"], st["m"], st["v"], st["adam_step"], 5,
                                               st["u_prev"], popt.opt_state.generator)
    tail = np.array(jax.random.uniform(jax_resample_key(jopt), (jopt.num_rollouts, 1, 1),
                                       minval=jopt.action_low, maxval=jopt.action_high,
                                       dtype=jnp.float32))
    s = np.array([0.1, -0.05, 0.2, 0.3], np.float32)
    params = both_params(jctrl)[1]
    u_jax = jctrl.step(s)
    u, state, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                                 torch.as_tensor(tail))
    js = jopt.opt_state
    q_tol = dict(rtol=1e-3, atol=1e-4) if kind == "gp" else Q_TOL
    moment_tol = GP_MOMENT_TOL if kind == "gp" else MOMENT_TOL
    np.testing.assert_allclose(diag["J_logged"].numpy(), jopt.logging_values["J_logged"],
                               **(GP_COST_TOL if kind == "gp" else UPDATE_COST_TOL))
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **q_tol)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **moment_tol)
    np.testing.assert_allclose(state.adam.v.numpy(), np.asarray(js.adam.v), **moment_tol)
    np.testing.assert_allclose(u.numpy(), u_jax, **q_tol)


# ---- one valued batched update of each gradient fleet ---------------------------------------
FLEET_MODELS = {"ode": ("ode", ("L",)), "ode_shared": ("ode", ()), "mlp": ("mlp", ()),
                "residual": ("residual", ("L",)), "gp": ("gp", ())}


def valued_fleet_pair(specs, name: str, model: str):  # noqa: F811
    jctrl, pctrl = fleet_pair(name, "ODE" if model == "ode" else specs[model],
                              grad_config(name))
    attach_both(jctrl, pctrl, jax_value_net(33, hiddens=(8, 8)), scale=3.0)
    return jctrl, pctrl


@pytest.mark.parametrize("case", list(FLEET_MODELS))
def test_one_valued_batched_rpgd_update_matches_jax(specs, case):  # noqa: F811
    """One valued batched rpgd-tf update from the JAX draws against the JAX
    package's ``_make_batched_rpgd_step`` (its value_spec and emit_terminal
    kernels in interpret mode): costs with V, controls, the population,
    the Adam moments, steps and counters, the ages."""
    model, per_slot = FLEET_MODELS[case]
    jctrl, pctrl = valued_fleet_pair(specs, "rpgd-tf", model)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = population(jopt, seed=50 + len(case))
    if not per_slot:
        x["L"] = np.float32(0.5)
    keys = slot_keys_jax()
    jstates = JaxRPGDState(
        key=keys, Q=jnp.asarray(x["Q"]),
        adam=JaxAdamState(step=jnp.asarray(ADAM_STEPS, jnp.int32), m=jnp.asarray(x["m"]),
                          v=jnp.asarray(x["v"])),
        trajectory_ages=jnp.asarray(x["ages"]), count=jnp.asarray(COUNTS, jnp.int32),
        u_prev=jnp.asarray(x["u_prev"]))
    jstep = jopt._make_batched_rpgd_step(FB, interpret=True, tile_k=FB * FKC,
                                         per_slot_dyn=per_slot)
    ju, jnew, jcosts = jstep(jstates, *jax_args(jctrl, x, model))
    states = rpgd_slot_states_from_numpy(x["Q"], x["m"], x["v"], ADAM_STEPS, x["ages"], COUNTS,
                                         x["u_prev"], (None,) * FB)
    _, update = popt._make_batched_rpgd_step(FB, per_slot_dyn=per_slot)
    draws = jax_rpgd_draws(jopt, keys, np.asarray(jcosts))
    u, new, costs = update(states, *port_args(jctrl, x, model), draws)
    assert_states_match(new, jnew, u, ju, costs, jcosts, model)
    np.testing.assert_array_equal(new.trajectory_ages.numpy(), np.asarray(jnew.trajectory_ages))


@pytest.mark.parametrize("case", list(FLEET_MODELS))
def test_one_valued_batched_gradient_update_matches_jax(specs, case):  # noqa: F811
    """One valued batched gradient-tf update from the JAX tails against the
    JAX package's ``_make_batched_gradient_step``."""
    model, per_slot = FLEET_MODELS[case]
    jctrl, pctrl = valued_fleet_pair(specs, "gradient-tf", model)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = population(jopt, seed=60 + len(case))
    if not per_slot:
        x["L"] = np.float32(0.5)
    keys = slot_keys_jax()
    jstates = JaxGradientState(
        key=keys, Q=jnp.asarray(x["Q"]),
        adam=JaxAdamState(step=jnp.asarray(ADAM_STEPS, jnp.int32), m=jnp.asarray(x["m"]),
                          v=jnp.asarray(x["v"])),
        count=jnp.asarray(COUNTS, jnp.int32), u_prev=jnp.asarray(x["u_prev"]))
    jstep = jopt._make_batched_gradient_step(FB, interpret=True, tile_k=FB * FKC,
                                             per_slot_dyn=per_slot)
    ju, jnew, jcosts = jstep(jstates, *jax_args(jctrl, x, model))
    tails = torch.stack([torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(k)[1], (FKC, 1, 1), minval=jopt.action_low, maxval=jopt.action_high,
        dtype=jnp.float32))) for k in keys])
    states = gradient_slot_states_from_numpy(x["Q"], x["m"], x["v"], ADAM_STEPS, COUNTS,
                                             x["u_prev"], (None,) * FB)
    _, update = popt._make_batched_gradient_step(FB, per_slot_dyn=per_slot)
    u, new, costs = update(states, *port_args(jctrl, x, model), tails)
    assert_states_match(new, jnew, u, ju, costs, jcosts, model)


@pytest.mark.parametrize("optimizer", ["rpgd-tf", "gradient-tf"])
def test_valued_fleet_gates_and_a_v_swap(specs, optimizer):  # noqa: F811
    """A valued ODE fleet takes its gradient gate and launches the value
    forms (on the CPU their plain versions); a new V reaches the next tick
    with nothing rebuilt."""
    from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
    from control_toolkit_tpu_torch.costs.value_terminal import (
        attach_value_terminal, update_value_params,
    )
    from test_torch_value import port_net

    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "device": "cpu",
                                        "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, optimizer_config=grad_config(optimizer),
                   num_slots=2)
    attach_value_terminal(ctrl, port_net(jax_value_net(34, hiddens=(8, 8))), 3.0)
    assert getattr(ctrl, "_batched_rpgd_eligible" if optimizer == "rpgd-tf"
                   else "_batched_gradient_eligible")()
    s = np.array([[0.05, 0.0, 0.1, 0.0], [-0.05, 0.0, -0.1, 0.0]], np.float32)
    epoch = ctrl.optimizer._build_epoch
    snap = ctrl.slot_states
    u1 = ctrl.step_batch(s)
    ctrl.slot_states = snap
    update_value_params(ctrl, port_net(jax_value_net(35, hiddens=(8, 8))))
    u2 = ctrl.step_batch(s)
    assert ctrl.optimizer._build_epoch == epoch and not np.allclose(u1, u2)


# ---- on a card -----------------------------------------------------------------------
CUDA_FORMS = ("k8", "k8_ens", "k9", "k10", "k7_cols", "k8_cols", "k9_cols", "k10_cols",
              "k1_cols_emit")


@pytest.mark.cuda
@pytest.mark.parametrize("form", CUDA_FORMS)
def test_cuda_value_forms_match_plain_versions(specs, cuda_device, form):  # noqa: F811
    """Each form on the card against its plain version on the same card
    tensors, within chip_smoke.py's bound for its kernel (the GP's
    well-conditioned); a zero-last-layer V gives the kernel's outputs bit
    for bit."""
    from chip_smoke import (
        DQ_ATOL_FRAC, DQ_RTOL, KERNEL_TOL, NET_TOL, X_TOL, close, seeded_value,
        well_conditioned_gp,
    )

    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(3)
    Kc, B = 1000, 10
    s0 = 0.05 * torch.randn(Kc, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(Kc, 50, 1, generator=gen, device=dev), -1.0, 1.0)
    ops = seeded_value(dev)
    zero = ops[:-2] + [torch.zeros_like(ops[-2]), torch.zeros_like(ops[-1])]
    kind = {"k8": "mlp", "k8_ens": "ensemble", "k9": "residual", "k10": "gp", "k7_cols": "ode",
            "k8_cols": "mlp", "k9_cols": "residual", "k10_cols": "gp",
            "k1_cols_emit": "ode"}[form]
    _, pctrl = valued_pair(spec_of(specs, kind), "rpgd-tf",
                           rpgd_config(num_rollouts=Kc, mpc_horizon=50))
    popt = pctrl.optimizer
    popt.device = dev
    params = pctrl._assemble_params()
    to = {k: v for k, v in params["dyn"].items()}
    if kind == "gp":
        to = {"gp": well_conditioned_gp({k: v.to(dev) for k, v in to["gp"].items()})}
    model, pack = {"ode": ode.rollout_model, "mlp": neural.net_model, "ensemble":
                   ensemble.net_model, "residual": residual.residual_model,
                   "gp": gp.gp_model}[kind](popt)
    pvec = pack(params, torch.tensor([0.1])).to(dev)

    def dev_tree(t):
        return {k: v.to(dev) for k, v in t.items()}

    weights = {"ode": (), "mlp": (dev_tree(to.get("net", {})),),
               "ensemble": (dev_tree(to.get("net", {})),),
               "residual": (dev_tree(to.get("res", {})),),
               "gp": (flatten_gp_weights(to["gp"]) if kind == "gp" else None,)}[kind]
    if form.endswith("cols") or form == "k1_cols_emit":
        pvec = pvec[None].repeat(B, 1).contiguous()
        pvec[:, -1] = torch.linspace(-0.3, 0.3, B, device=dev)
    tol = NET_TOL if kind in ("mlp", "ensemble", "residual") else KERNEL_TOL
    args = (model, s0, Q, pvec, *weights)
    if form == "k1_cols_emit":
        (c, x), (rc, rx) = cost_rollout_cols_emit(*args), cost_rollout_cols_emit_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(c, rc, **tol)
        torch.testing.assert_close(x, rx, **X_TOL)
        assert torch.equal(c, cost_rollout_cols(*args))
        return
    forms = {"k8": (neural_grad_cost_rollout_value, neural_grad_cost_rollout_plain,
                    neural_grad_cost_rollout),
             "k8_ens": (neural_grad_cost_rollout_ens_value,
                        neural_grad_cost_rollout_ens_value_plain, neural_grad_cost_rollout_ens),
             "k9": (residual_grad_cost_rollout_value, residual_grad_cost_rollout_plain,
                    residual_grad_cost_rollout),
             "k10": (gp_grad_cost_rollout_value, gp_grad_cost_rollout_plain,
                     gp_grad_cost_rollout),
             "k7_cols": (grad_cost_rollout_cols_value, grad_cost_rollout_cols_plain,
                         grad_cost_rollout_cols),
             "k8_cols": (neural_grad_cost_rollout_cols_value,
                         neural_grad_cost_rollout_cols_plain, neural_grad_cost_rollout_cols),
             "k9_cols": (residual_grad_cost_rollout_cols_value,
                         residual_grad_cost_rollout_cols_plain, residual_grad_cost_rollout_cols),
             "k10_cols": (gp_grad_cost_rollout_cols_value, gp_grad_cost_rollout_cols_plain,
                          gp_grad_cost_rollout_cols)}
    kernel_fn, plain_fn, unvalued = forms[form]
    got, ref = kernel_fn(*args, ops), plain_fn(*args, ops)
    zero_got, base = kernel_fn(*args, zero), unvalued(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], **tol)
    assert close(got[1], ref[1], DQ_RTOL, DQ_ATOL_FRAC)
    assert torch.equal(zero_got[0], base[0]) and torch.equal(zero_got[1], base[1])
