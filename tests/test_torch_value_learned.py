"""The port's learned value terminal over the learned dynamics against the
JAX package: the ``emit_terminal`` forms of K11 (and its member-block
form), K12, K13 and K14, the valued MPPI, CEM, iCEM and random-action
updates over each learned model, and the valued MPPI fleets over the MLP,
``"ODE+res"`` and the GP.

Each form's plain version is held to the JAX kernel built with
``emit_terminal=True`` in interpret mode (its family's ``build_cost`` with
the value hook left out, ``_finalize_cost_kernel`` the identity on both
sides, so the kernel's raw ``(cost, x_H)`` comes back): the single-session
forms over a JAX-initialised ``mlp-16`` with norms, ``GRU-5IN-8H1-4OUT``,
``LSTM-5IN-8H1-4OUT`` (both from a nonzero live hidden), ``"ODE+res"``
with a nonzero residual, the committed ``SGP_128`` and the committed
four-member ``mlp-32-32`` ensemble (the member-block form); the session-row
(``slot_keys``) forms over the MLP, the residual (per-slot pole lengths)
and the GP, the JAX kernel taken from its batched step.  Costs to
COST_TOL, x_H to X_TOL.  One valued update of each optimizer over each of
the five learned models is fed the JAX draws and held to the JAX package's
(which, off a TPU, takes its XLA scan with V in the terminal cost:
test_value_terminal.py:165's oracle), as is the valued fleet update
(test_value_terminal.py:831).  On a machine with a card, each CUDA form is
held to its plain version, its costs equal to its kernel's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.models import gp_predictor as jgp
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu.optimizers.base import make_slot_packer as jax_slot_packer
from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.ops import gp_rollout, neural_rollout, residual_rollout
from control_toolkit_tpu_torch.ops.gp_rollout import flatten_gp_weights
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.icem import ICEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import ensemble, gp, neural, residual
from control_toolkit_tpu_torch.optimizers.random_action import RandomActionState
from control_toolkit_tpu_torch.utils.convert import (
    mppi_slot_states_from_numpy, params_from_numpy,
)
from control_toolkit_tpu_torch.utils.device import place
from test_torch_cem import jax_draws
from test_torch_fleet_learned import fleet_inputs, jax_update, port_update, with_slot_dyn
from test_torch_fleet_learned import make_pair as fleet_pair
from test_torch_gp import COST_TOL as GP_COST_TOL
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import (
    CPU, COST_TOL, LIMITS, UNOM_TOL, jax_next_draw, jax_params_numpy, optimizer_config,
    port_noise, set_shared_state,
)
from test_torch_neural import jax_net
from test_torch_residual import bench_residual
from test_torch_value import ASSETS, STATE_TOL, attach_both, jax_value_net
from test_torch_zoo import icem_config, jax_white

K, H, TILE = 128, 8, 64
X_TOL = STATE_TOL  # the terminal states: test_torch_value.py's bound
# The GP: a small one the JAX package fits (test_torch_gp.py's), its costs
# to the JAX GP kernel tests' own bound (GP_COST_TOL).
GP_M = 16
NETS = {"mlp": "mlp-16", "gru": "GRU-5IN-8H1-4OUT", "lstm": "LSTM-5IN-8H1-4OUT"}
LEARNED = ("mlp", "gru", "residual", "gp", "ensemble")
# kind: (the port's family, the JAX optimizer's builder of its cost kernel)
FAMILIES = {"mlp": (neural, "_build_pallas_neural_cost"),
            "gru": (neural, "_build_pallas_neural_cost"),
            "lstm": (neural, "_build_pallas_neural_cost"),
            "residual": (residual, "_build_pallas_residual_cost"),
            "gp": (gp, "_build_pallas_gp_cost"),
            "ensemble": (ensemble, "_build_pallas_ensemble_cost")}
# The session-row forms: the port's plain version and wrapper, the JAX
# batched step that builds the kernel, the per-slot dynamics.
COLS = {"mlp": (neural_rollout.neural_cost_rollout_cols_emit_plain,
                "_make_batched_neural_step", ()),
        "residual": (residual_rollout.residual_cost_rollout_cols_emit_plain,
                     "_make_batched_residual_step", ("L",)),
        "gp": (gp_rollout.gp_cost_rollout_cols_emit_plain, "_make_batched_gp_step", ())}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    """Each learned model's predictor specification (the nets written by
    the JAX package's ``save_net``)."""
    root = tmp_path_factory.mktemp("value_learned")
    out = {"residual": "ODE+res", "ensemble": f"ensemble:mlp-32-32:4:{ASSETS}"}
    for i, (kind, name) in enumerate(NETS.items()):
        jnets.save_net(root / f"{name}.npz", jax_net(name, seed=20 + i, norms=kind == "mlp"),
                       meta={"predict_delta": True})
        out[kind] = f"neural:{name}:{root}"
    params, _ = jgp.fit_gp_dynamics(*random_transitions(), num_inducing=GP_M, seed=0)
    jgp.GPPredictor("cartpole", dt=0.02, params=params).save(root / "sgp.npz")
    out["gp"] = f"SGP_{GP_M}:{root / 'sgp.npz'}"
    return out


def random_transitions(batch: int = 8, steps: int = 40, seed: int = 0):
    """``(x, u, x_next)`` of ``steps`` random-action steps of ``batch``
    cartpoles (the port's CartpoleEnv), the GP's training data."""
    env, rng = CartpoleEnv(batch_size=batch, dt=0.02, seed=seed), np.random.default_rng(seed)
    s, _ = env.reset()
    xs, us, xns = [], [], []
    for _ in range(steps):
        u = rng.uniform(-1.0, 1.0, (batch, 1)).astype(np.float32)
        s_next, *_ = env.step(u)
        xs.append(s), us.append(u), xns.append(s_next)
        s = s_next
    return tuple(np.concatenate(a).astype(np.float32) for a in (xs, us, xns))


def cost_tol(kind: str) -> dict:
    return GP_COST_TOL if kind == "gp" else COST_TOL


def install_residual(jctrl, pctrl) -> None:
    """The same nonzero residual in both "ODE+res" predictors."""
    jpred = jctrl.optimizer.predictor.predictor
    res = bench_residual(jpred._res)
    jpred.set_residual(res)
    jctrl._dyn_params = None
    pctrl.optimizer.predictor.predictor.set_residual(res)


def set_hidden(jctrl, pctrl, seed: int) -> None:
    """Both recurrent predictors at one nonzero live hidden."""
    jpred, ppred = jctrl.optimizer.predictor.predictor, pctrl.optimizer.predictor.predictor
    if not getattr(ppred, "recurrent", False):
        return
    rng = np.random.default_rng(seed)
    hidden = tuple((0.3 * rng.standard_normal(np.shape(h))).astype(np.float32)
                   for h in jpred.hidden)
    jpred.hidden = tuple(jnp.asarray(h) for h in hidden)
    ppred.hidden = tuple(torch.tensor(h) for h in hidden)


def valued_pair(spec: str, optimizer: str, config: dict, seed: int = 3):
    """The JAX and the port controller over ``spec`` with one value net
    (4-16-1, scale 3) attached to both."""
    ctrls = []
    for Ctrl, extra in ((JaxMPC, {}), (MPCController, {"device": "cpu"})):
        ctrl = Ctrl("cartpole", LIMITS, {"target_position": 0.3},
                    config={"optimizer": optimizer, "controller_logging": False, **extra})
        ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                       optimizer_config=dict(config))
        ctrls.append(ctrl)
    jctrl, pctrl = ctrls
    if spec == "ODE+res":
        install_residual(jctrl, pctrl)
    attach_both(jctrl, pctrl, jax_value_net(seed, hiddens=(16,)))
    set_hidden(jctrl, pctrl, seed + 1)
    return jctrl, pctrl


def both_params(jctrl):
    tree = jax_params_numpy(jctrl)
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(tree, CPU))


def cost_inputs(Kc: int, Hc: int, seed: int):
    rng = np.random.default_rng(seed)
    s_tiled = np.tile(rng.uniform(-0.3, 0.3, (1, 4)).astype(np.float32), (Kc, 1))
    Q = rng.uniform(-1.0, 1.0, (Kc, Hc, 1)).astype(np.float32)
    return s_tiled, Q, np.array([0.25], np.float32)


def raw_emit(opt):
    """Leave the value hook out of ``opt``'s cost kernel: its family then
    returns the emit_terminal form's raw ``(cost, x_H)``."""
    opt._finalize_cost_kernel = lambda raw_call, post: raw_call


# ---- each form's plain version against the JAX kernel (interpret mode) ----------------
@pytest.mark.parametrize("kind", list(FAMILIES))
def test_emit_plain_matches_pallas_interpret(specs, kind):
    """The single-session emit_terminal form (K11, K13 GRU and LSTM, K12,
    K14, K11's member-block form): costs and x_H against the JAX kernel
    built with ``emit_terminal=True`` (interpret mode), then the valued
    cost (V outside the kernel) against the JAX package's trajectory cost
    with V in its terminal cost."""
    family, builder = FAMILIES[kind]
    jctrl, pctrl = valued_pair(specs[kind], "mppi", optimizer_config(K, H), seed=len(kind))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert family.can_use_cost(popt) and popt._post_terminal_fn() is not None
    s_tiled, Q, u_prev = cost_inputs(K, H, seed=7)
    jargs = (jnp.asarray(s_tiled), jnp.asarray(Q), jnp.asarray(u_prev))
    pargs = (torch.tensor(s_tiled), torch.tensor(Q), torch.tensor(u_prev))
    jparams, params = both_params(jctrl)
    raw_emit(jopt)
    raw_emit(popt)
    tile = TILE if kind != "ensemble" else K // 4
    ref_cost, ref_x = getattr(jopt, builder)(interpret=True, tile_k=tile)(*jargs, jparams)
    cost, x = family.build_cost(popt)(*pargs, params)
    assert x.shape == (K, 4)
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **cost_tol(kind))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), **X_TOL)
    del jopt._finalize_cost_kernel, popt._finalize_cost_kernel
    valued = popt._make_cost_only()(*pargs, params)
    ref = jopt._rollout_and_cost(*jargs, jparams)[0]
    np.testing.assert_allclose(valued.numpy(), np.asarray(ref), **cost_tol(kind))
    assert not np.allclose(valued.numpy(), cost.numpy())  # V reached the costs


@pytest.mark.parametrize("Kc", [64, 40])
@pytest.mark.parametrize("kind", list(COLS))
def test_session_row_emit_plain_matches_pallas_interpret(specs, kind, Kc):
    """The session-row emit_terminal form of K11, K12 and K14: B=3 sessions'
    costs and x_H against the JAX kernel its valued batched MPPI step builds
    (``slot_keys`` with ``emit_terminal``, interpret mode, one tile of B*K),
    each session with its own target, previous control and (the residual)
    pole length; at K=40 the 16-rollout groups straddle sessions."""
    plain, builder, per_slot = COLS[kind]
    B = 3
    jctrl, pctrl = valued_pair(specs[kind], "mppi", optimizer_config(Kc, H), seed=11)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    got = {}

    def grab(B_, kernel, weights_fn, shared_keys, slot_keys, dyn_leaves_fn=None, post=None):
        got.update(kernel=kernel, weights=weights_fn, shared=shared_keys, slot=slot_keys,
                   leaves=dyn_leaves_fn or (lambda dyn: dyn), post=post)
        return None, None

    jopt._batched_columns_step_from_kernel = grab
    kw = {"per_slot_dyn": per_slot} if per_slot else {}
    getattr(jopt, builder)(B, interpret=True, tile_k=B * Kc, **kw)
    assert got["post"] is not None
    rng = np.random.default_rng(Kc)
    u_prev = rng.uniform(-0.5, 0.5, (B, 1)).astype(np.float32)
    target = np.linspace(-0.3, 0.3, B).astype(np.float32)
    L = np.linspace(0.35, 0.65, B).astype(np.float32)
    s0 = np.repeat(rng.uniform(-0.3, 0.3, (B, 4)).astype(np.float32), Kc, axis=0)
    Q = rng.uniform(-1.0, 1.0, (B * Kc, H, 1)).astype(np.float32)
    jparams, params = both_params(jctrl)
    jdyn = with_slot_dyn(jparams["dyn"], kind, jnp.asarray(L))
    pvec, pslot = jax_slot_packer(got["shared"], got["slot"],
                                  jopt.cost_function.cost_function.attr_defaults, B, Kc)(
        jnp.asarray(u_prev), got["leaves"](jdyn), jparams["cost"],
        {"target_position": jnp.asarray(target)})
    ref_cost, ref_x = got["kernel"](jnp.asarray(s0), jnp.asarray(Q), pvec, pslot,
                                    *got["weights"](jdyn))
    model = {"mlp": neural.net_model, "residual": residual.residual_model,
             "gp": gp.gp_model}[kind](popt)[0]
    dyn = with_slot_dyn(params["dyn"], kind, torch.tensor(L))
    leaves = dyn["base"] if kind == "residual" else dyn
    _, slot_keys = split_slot_keys(model.param_keys, per_slot)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, CPU)(
        torch.tensor(u_prev), leaves, params["cost"], {"target_position": torch.tensor(target)})
    weights = {"mlp": lambda: dyn["net"], "residual": lambda: dyn["res"],
               "gp": lambda: flatten_gp_weights(dyn["gp"])}[kind]()
    cost, x = plain(model, torch.tensor(s0), torch.tensor(Q), pvec_b, weights)
    assert cost.shape == (B, Kc) and x.shape == (B, Kc, 4)
    np.testing.assert_allclose(cost.numpy().reshape(-1), np.asarray(ref_cost), **cost_tol(kind))
    np.testing.assert_allclose(x.numpy().reshape(-1, 4), np.asarray(ref_x), **X_TOL)


# ---- one valued update of each optimizer over each learned model --------------------
def mppi_update(jctrl, pctrl, s):
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_shared_state(jopt, popt)
    delta = jax_next_draw(jopt)
    params = params_from_numpy(jax_params_numpy(jctrl), CPU)  # the hidden before the step
    u_jax = jctrl.step(s)
    u, _, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params,
                             port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom),
                               **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


def cem_states(jopt, popt, elites: bool):
    rng = np.random.default_rng(1)
    Hh = jopt.mpc_horizon
    mue = rng.uniform(-0.4, 0.4, (1, Hh, 1)).astype(np.float32)
    std = rng.uniform(0.2, 0.6, (1, Hh, 1)).astype(np.float32)
    u_prev = np.array([0.2], np.float32)
    common = dict(dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std),
                  count=jnp.asarray(1, jnp.int32), u_prev=jnp.asarray(u_prev))
    gen = popt.opt_state.generator
    if not elites:
        jopt.opt_state = jopt.opt_state._replace(**common)
        popt.opt_state = CEMState(gen, torch.tensor(mue), torch.tensor(std), 1,
                                  torch.tensor(u_prev))
        return
    el = rng.uniform(-0.8, 0.8, (popt.n_keep, Hh, 1)).astype(np.float32)
    jopt.opt_state = jopt.opt_state._replace(elites=jnp.asarray(el), **common)
    popt.opt_state = ICEMState(gen, torch.tensor(mue), torch.tensor(std), torch.tensor(el), 1,
                               torch.tensor(u_prev))


def cem_update(jctrl, pctrl, s, icem: bool, tol: dict):
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    cem_states(jopt, popt, icem)
    if icem:
        key, draws = jopt.opt_state.key, []
        for _ in range(2):
            key, sub = jax.random.split(key)
            draws.append(torch.tensor(jax_white(sub, jopt.mpc_horizon, (popt._n_fresh, 1))))
    else:
        draws = jax_draws(jopt, 2, False)
    jparams, params = both_params(jctrl)
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]), **tol)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    for name in ("dist_mue", "stdev") + (("elites",) if icem else ()):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL)


def random_action_update(jctrl, pctrl, s):
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    u_prev = np.array([0.3], np.float32)
    jopt.opt_state = jopt.opt_state._replace(u_prev=jnp.asarray(u_prev))
    popt.opt_state = RandomActionState(popt.opt_state.generator, torch.tensor(u_prev))
    _, sample_key = jax.random.split(jopt.opt_state.key)
    Q = np.asarray(jax.random.uniform(sample_key, (jopt.num_rollouts, jopt.mpc_horizon, 1),
                                      minval=jopt.action_low, maxval=jopt.action_high,
                                      dtype=jnp.float32))
    jparams, params = both_params(jctrl)
    u_j, _, _ = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, _, _ = popt.update(popt.opt_state, torch.tensor(s)[None], params, torch.tensor(Q))
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_j))  # the same row of the same Q


UPDATE_CONFIGS = {
    "mppi": optimizer_config(64, H),
    "cem-tf": {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 64,
               "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
               "cem_best_k": 16, "warmup": False, "fully_fused": False},
    "icem-tf": icem_config(num_rollouts=64, mpc_horizon=H, cem_best_k=16),
    "random-action-tf": {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 64},
}


@pytest.mark.parametrize("kind", LEARNED)
@pytest.mark.parametrize("optimizer", list(UPDATE_CONFIGS))
def test_one_valued_update_matches_jax(specs, optimizer, kind):
    """One update of MPPI, CEM, iCEM or random-action with V over each
    learned model, fed the JAX draws: the port's costs come from the
    family's emit_terminal form (its plain version) plus V/(H+1), the JAX
    package's from its loop with V in the terminal cost."""
    jctrl, pctrl = valued_pair(specs[kind], optimizer, UPDATE_CONFIGS[optimizer], seed=5)
    assert FAMILIES[kind][0].can_use_cost(pctrl.optimizer)
    s = np.array([0.1, -0.05, 0.3, 0.2], np.float32)
    if optimizer == "mppi":
        mppi_update(jctrl, pctrl, s)
    elif optimizer == "random-action-tf":
        random_action_update(jctrl, pctrl, s)
    else:
        cem_update(jctrl, pctrl, s, optimizer == "icem-tf", cost_tol(kind))


@pytest.mark.parametrize("option", [{"risk_weight": 0.7}, {"robust_eval": "worst"}])
def test_valued_ensemble_risk_and_robust_match_jax(specs, option):
    """A valued MPPI update over the ensemble with ``risk_weight`` (the
    member-block emit form, V, then the members' disagreement) and with
    ``robust_eval`` (every plan under the four members, V in each member's
    trajectory cost; no kernel), as the JAX package composes them
    (base.py:558-620)."""
    jctrl, pctrl = valued_pair(specs["ensemble"], "mppi", optimizer_config(64, H, **option))
    assert pctrl.optimizer._post_terminal_fn() is not None
    mppi_update(jctrl, pctrl, np.array([0.1, -0.05, 0.3, 0.2], np.float32))


# ---- the valued fleets ---------------------------------------------------------------
@pytest.mark.parametrize("kind", list(COLS))
def test_valued_fleet_update_matches_jax(specs, kind):
    """One valued batched MPPI update over the MLP, "ODE+res" (per-slot pole
    lengths) and the GP, fed the same per-session inputs and noise, against
    the JAX step's (``_make_batched_*_step(B, interpret=True)``'s
    ``update_from_eps``): each session's V(x_H)/(H+1) joins its costs before
    the softmax."""
    B, Kc = 3, 64
    jctrl, pctrl = fleet_pair(specs[kind], Kc)
    attach_both(jctrl, pctrl, jax_value_net(41, hiddens=(16,)), scale=4.0)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = fleet_inputs(popt, B, Kc, [], seed=Kc + len(kind))
    jp = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), jctrl._assemble_params())
    jstates = JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32), u_nom=jnp.asarray(x["u_nom"]),
                           u_prev=jnp.asarray(x["u_prev"]))
    u_ref, c_ref = jax_update(kind, jopt, B, B * Kc)(
        jstates, jnp.asarray(x["s"]), with_slot_dyn(jp["dyn"], kind, jnp.asarray(x["L"])),
        jp["cost"], {"target_position": jnp.asarray(x["target"])}, jnp.asarray(x["delta"]))
    pp = params_from_numpy(jax_params_numpy(jctrl), CPU)
    states = mppi_slot_states_from_numpy(x["u_nom"], x["u_prev"], (None,) * B)
    u_nom, costs = port_update(kind, popt, B)(
        states, torch.tensor(x["s"]), with_slot_dyn(pp["dyn"], kind, torch.tensor(x["L"])),
        pp["cost"], {"target_position": torch.tensor(x["target"])}, torch.tensor(x["delta"]))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **cost_tol(kind))
    np.testing.assert_allclose(u_nom.numpy(), np.asarray(u_ref), **UNOM_TOL)


# ---- on a card --------------------------------------------------------------------------
CUDA_FORMS = ("mlp", "mlp_cols", "gru", "lstm", "residual", "residual_cols", "gp", "gp_cols",
              "ensemble")


def card_problem(specs, form: str, Kc: int, dev):
    """``(emit, kernel, plain, args)`` of ``form`` on the card: Kc rollouts
    (the session-row forms: 3 sessions of Kc)."""
    kind, cols = form.split("_")[0], form.endswith("_cols")
    _, pctrl = valued_pair(specs[kind], "mppi", optimizer_config(K, H))
    popt = pctrl.optimizer
    params = pctrl._assemble_params()
    g = torch.Generator(device=dev).manual_seed(0)
    B = 3 if cols else 1
    s0 = (0.05 * torch.randn(B, 4, generator=g, device=dev)).repeat_interleave(Kc, dim=0)
    Q = torch.clamp(0.3 * torch.randn(B * Kc, H, 1, generator=g, device=dev), -1.0, 1.0)
    model, pack = {"residual": residual.residual_model, "gp": gp.gp_model,
                   "ensemble": ensemble.net_model}.get(kind, neural.net_model)(popt)
    dyn = place(params["dyn"], dev)
    pvec = pack(params, torch.tensor([0.1])).to(dev)
    if cols:
        pvec = pvec.expand(B, -1).contiguous()
    ops = {"residual": lambda: dyn["res"], "gp": lambda: flatten_gp_weights(dyn["gp"])}.get(
        kind, lambda: dyn["net"])()
    args = (model, s0, Q, pvec, ops) + ((dyn["hidden"],) if kind in ("gru", "lstm") else ())
    mod = {"residual": residual_rollout, "gp": gp_rollout}.get(kind, neural_rollout)
    name = {"mlp": "neural_cost_rollout", "gru": "recurrent_cost_rollout",
            "lstm": "recurrent_cost_rollout", "residual": "residual_cost_rollout",
            "gp": "gp_cost_rollout", "ensemble": "neural_cost_rollout_ens"}[kind]
    name += "_cols" if cols else ""
    return (getattr(mod, name + "_emit"), getattr(mod, name),
            getattr(mod, name + "_emit_plain"), args)


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [1000, 512])
@pytest.mark.parametrize("form", CUDA_FORMS)
def test_cuda_emit_forms_match_plain_versions(specs, cuda_device, form, Kc):
    """Each emit_terminal form on the card against its plain version on the
    same card tensors (chip_smoke.py's bounds: NET_TOL or RNN_TOL on costs,
    X_TOL on x_H), its costs equal to its kernel's bit for bit; at a ragged
    K too, one launch counted."""
    from chip_smoke import NET_TOL, RNN_TOL
    from chip_smoke import X_TOL as CARD_X_TOL

    emit, kernel, plain, args = card_problem(specs, form, Kc, cuda_device)
    before = emit.launches
    (cost, x), (rc, rx) = emit(*args), plain(*args)
    assert emit.launches == before + 1
    assert torch.equal(cost, kernel(*args))
    tol = RNN_TOL if form in ("gru", "lstm") else NET_TOL
    assert torch.allclose(cost, rc, **tol) and torch.allclose(x, rx, **CARD_X_TOL)
