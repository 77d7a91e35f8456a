"""The learned-dynamics kernels over the pendulum, acrobot, point-mass,
quadrotor, car and arm costs against the JAX package: every form of K11
(plain, emit_terminal, member-block and its emit_terminal form, session-row
and its emit_terminal form), K13 (GRU and LSTM: plain, emit_terminal,
session-row), K14 (plain, emit_terminal, session-row and its emit_terminal
form) and K10 (plain, value_spec, session-row and its value_spec form), and
the paths that run them.

A network or GP kernel's plant is its cost's (the dynamics are tensors),
so each of the nine costs other than cartpole's is an instance of each
form.  Each form's plain version is held, for every cost, to the JAX kernel
the JAX package builds for it, in interpret mode (B=2 sessions, H=8): the
optimizer's ``_build_pallas_*`` kernels (the emit_terminal and value_spec
forms under a seeded value net of the plant's S, the value hook left out of
the cost kernel so that its raw ``(cost, x_H)`` comes back), the
session-row ones captured from the JAX batched steps and binder.  The nets
are narrow, seeded with numpy at the plant's widths: an MLP 16-16 with
norms, a GRU and an LSTM of 8 from a nonzero live hidden, two members of
mlp-16-16, and a sparse GP of M=16 inducing points, each written by the
JAX package's own ``save_net`` / ``GPPredictor.save`` and read by both
packages.  One update of each path (MPPI and CEM over the MLP, the GRU and
the LSTM; MPPI over the GP and the ensemble; valued MPPI over the MLP and
the GP; rpgd-tf over the GP, plain and valued; the MPPI fleet over the MLP,
the GRU and the GP; the rpgd-tf fleet over the GP) is held to the JAX
package's step fed its draws over the pendulum, pointmass/obstacles, the
3-D quadrotor (S=12, U=4: K13's two input and two head tiles on the card)
and car/obstacles.

Tolerances, each with its reason: the nets' costs to test_torch_mppi.py's
COST_TOL, the MLP's, GRU's and LSTM's as test_torch_value_learned.py holds
cartpole's (the JAX kernel's matmuls sum in another order); the GP's costs
and dQ to test_torch_gp.py's COST_TOL and GRAD_TOL (the JAX GP kernel
tests' own bounds: the RBF's exp amplifies the reassociation); x_H to
test_torch_value.py's STATE_TOL; the steps to the bounds of the cartpole
tests they follow (test_torch_mppi.py's UNOM_TOL, test_torch_rpgd.py's
Q_TOL and MOMENT_TOL, test_torch_fleet_learned.py's fleet bounds).  On a
machine with a card every cost's instance of each form is held to its plain
version (``-m cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.models import ensemble_predictor as jens
from control_toolkit_tpu.models import gp_predictor as jgp
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu.ops.common import AdamState as JaxAdamState
from control_toolkit_tpu.optimizers import kernel_families as jkf
from control_toolkit_tpu.optimizers.kernel_families.batched import (
    bind_batched_grad_kernels as jax_bind_batched,
)
from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
from control_toolkit_tpu.optimizers.rpgd import RPGDState as JaxRPGDState
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import (
    gp_grad_cost_rollout, gp_grad_cost_rollout_cols, gp_grad_cost_rollout_cols_plain,
    gp_grad_cost_rollout_cols_value, gp_grad_cost_rollout_lanes, gp_grad_cost_rollout_plain,
    gp_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.gp_rollout import (
    flatten_gp_weights, gp_cost_rollout, gp_cost_rollout_cols, gp_cost_rollout_cols_emit,
    gp_cost_rollout_cols_emit_plain, gp_cost_rollout_cols_plain, gp_cost_rollout_emit,
    gp_cost_rollout_emit_plain, gp_cost_rollout_lanes, gp_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain,
    neural_grad_cost_rollout_cols_value, neural_grad_cost_rollout_ens,
    neural_grad_cost_rollout_ens_plain, neural_grad_cost_rollout_ens_value,
    neural_grad_cost_rollout_ens_value_plain, neural_grad_cost_rollout_plain,
    neural_grad_cost_rollout_value,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    neural_cost_rollout, neural_cost_rollout_cols, neural_cost_rollout_cols_emit,
    neural_cost_rollout_cols_emit_plain, neural_cost_rollout_cols_plain,
    neural_cost_rollout_emit, neural_cost_rollout_emit_plain, neural_cost_rollout_ens,
    neural_cost_rollout_ens_emit, neural_cost_rollout_ens_emit_plain,
    neural_cost_rollout_ens_plain, neural_cost_rollout_plain, recurrent_cost_rollout,
    recurrent_cost_rollout_cols, recurrent_cost_rollout_cols_plain, recurrent_cost_rollout_emit,
    recurrent_cost_rollout_emit_plain, recurrent_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.cem import CEMState
from control_toolkit_tpu_torch.optimizers.kernel_families import ensemble, gp, neural
from control_toolkit_tpu_torch.utils.convert import (
    mppi_slot_states_from_numpy, mppi_state_from_numpy, params_from_numpy,
    rpgd_slot_states_from_numpy, rpgd_state_from_numpy,
)
from test_torch_fleet_grad import ADAM_STEPS
from test_torch_fleet_learned import COST_TOL as FLEET_COST_TOL
from test_torch_fleet_learned import UNOM_TOL as FLEET_UNOM_TOL
from test_torch_gp import COST_TOL as GP_COST_TOL
from test_torch_gp import GRAD_TOL as GP_GRAD_TOL
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, COST_TOL, UNOM_TOL, jax_next_draw, jax_params_numpy, port_noise
from test_torch_plants import (
    DIMS, PLANTS, controls, limits, make_pair, mppi_config, rpgd_config, states,
)
from test_torch_plants_fleets import FLEET_LABELS, RPGD_COUNTS
from test_torch_rpgd import MOMENT_TOL, Q_TOL, jax_rpgd_draw
from test_torch_value import STATE_TOL, attach_both, jax_value_net

B, HF, KS = 2, 8, 32
# The nine costs other than cartpole's, by plant (kernels.COST_PLANTS).
COSTS = tuple(p for p in kernels.COST_PLANTS if p != "cartpole")
# Each learned model's net (its architecture's name) and the GP's points.
NETS = {"mlp": "mlp-16-16", "gru": "GRU-8H1", "lstm": "LSTM-8H1"}
ENS_NET, ENS_MEMBERS, GP_M = "mlp-16-16", 2, 16
KINDS = ("mlp", "gru", "lstm", "ensemble", "gp")
VALUE_SCALE = 2.0
# The 17 forms this file holds, by the KERNEL_PLANTS entry each carries.
FORMS = ("K10", "K10's value_spec form", "K10's session-row form",
         "K10's session-row value_spec form", "K11", "K11's emit_terminal form",
         "K11's member-block form", "K11's member-block emit_terminal form",
         "K11's session-row form", "K11's session-row emit_terminal form", "K13",
         "K13's emit_terminal form", "K13's session-row form", "K14", "K14's emit_terminal form",
         "K14's session-row form", "K14's session-row emit_terminal form")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def gp_params(S: int, U: int, seed: int) -> dict:
    """A sparse GP of GP_M inducing points over [x, u] of S + U columns in
    the JAX package's parameter form, whose mean moves each state by up to
    ~0.1 a step."""
    rng = np.random.default_rng(seed)
    D = S + U
    return {"Z": rng.uniform(-1.0, 1.0, (GP_M, D)).astype(np.float32),
            "lengthscales": rng.uniform(0.8, 1.6, D).astype(np.float32),
            "variance": np.float32(0.8),
            "alpha": (0.05 * rng.standard_normal((GP_M, S))).astype(np.float32),
            "in_mean": (0.1 * rng.standard_normal(D)).astype(np.float32),
            "in_std": rng.uniform(0.8, 1.2, D).astype(np.float32),
            "out_mean": np.full(S, 0.001, np.float32),
            "out_std": rng.uniform(0.5, 1.0, S).astype(np.float32)}


def dense(rng, fan_in: int, shape: tuple) -> np.ndarray:
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def mlp_net(rng, dims: list, lead: tuple = ()) -> dict:
    """A seeded MLP ``dims[0] -> ... -> dims[-1]`` (``lead``: a stacked
    ensemble's member axis) in the JAX package's form."""
    net = {}
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        net[f"w{i}"] = dense(rng, fi, lead + (fi, fo))
        net[f"b{i}"] = (0.1 * rng.standard_normal(lead + (fo,))).astype(np.float32)
    return net


def rnn_net(rng, kind: str, d_in: int, hidden: int, d_out: int) -> dict:
    """A seeded one-cell GRU or LSTM with its head, in the JAX package's
    form (``cell0/{wi, bi, wh, bh}``, ``wo``, ``bo``)."""
    gates = 3 if kind == "gru" else 4
    return {"cell0": {"wi": dense(rng, d_in, (d_in, gates * hidden)),
                      "bi": (0.1 * rng.standard_normal(gates * hidden)).astype(np.float32),
                      "wh": dense(rng, hidden, (hidden, gates * hidden)),
                      "bh": (0.1 * rng.standard_normal(gates * hidden)).astype(np.float32)},
            "wo": dense(rng, hidden, (hidden, d_out)),
            "bo": (0.01 * rng.standard_normal(d_out)).astype(np.float32)}


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    """``spec(plant, kind)``: the predictor specification of the learned
    model ``kind`` over the plant, a checkpoint the JAX package wrote at
    the plant's widths (made at first use, a directory a cost)."""
    root, made = tmp_path_factory.mktemp("plants_nets"), {}

    def spec(plant: str, kind: str) -> str:
        if (plant, kind) in made:
            return made[plant, kind]
        env = PLANTS[plant][0]
        S, U = DIMS[env]
        where = root / plant
        where.mkdir(exist_ok=True)
        rng = np.random.default_rng([COSTS.index(plant), KINDS.index(kind)])
        if kind == "mlp":
            net = mlp_net(rng, [S + U, 16, 16, S])
            net.update(norm_in_mean=(0.1 * rng.standard_normal(S + U)).astype(np.float32),
                       norm_in_std=rng.uniform(0.8, 1.5, S + U).astype(np.float32),
                       norm_out_mean=np.full(S, 0.02, np.float32),
                       norm_out_std=rng.uniform(0.2, 0.5, S).astype(np.float32))
            jnets.save_net(where / f"{NETS[kind]}.npz", net, meta={"predict_delta": True})
            made[plant, kind] = f"neural:{NETS[kind]}:{where}"
        elif kind in ("gru", "lstm"):
            jnets.save_net(where / f"{NETS[kind]}.npz", rnn_net(rng, kind, S + U, 8, S),
                           meta={"predict_delta": True})
            made[plant, kind] = f"neural:{NETS[kind]}:{where}"
        elif kind == "ensemble":
            jnets.save_net(where / jens.ensemble_checkpoint_name(ENS_NET, ENS_MEMBERS),
                           mlp_net(rng, [S + U, 16, 16, S], (ENS_MEMBERS,)),
                           meta={"predict_delta": True, "n_members": ENS_MEMBERS})
            made[plant, kind] = f"ensemble:{ENS_NET}:{ENS_MEMBERS}:{where}"
        else:
            jgp.GPPredictor(env, dt=0.02, params=gp_params(S, U, COSTS.index(plant))).save(
                where / "sgp.npz")
            made[plant, kind] = f"SGP_{GP_M}:{where / 'sgp.npz'}"
        return made[plant, kind]

    return spec


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


def nets_pair(specs, plant: str, kind: str, optimizer: str, cfg: dict, valued: bool = False,
              seed: int = 3):
    """The JAX and the port ``mpc`` controllers over the plant's cost and
    the learned model ``kind`` (one checkpoint), with one nonzero live
    hidden (a recurrent net) and the same seeded value net of the plant's S
    (``valued``); and the params in both forms."""
    jctrl, pctrl = make_pair(plant, optimizer, cfg, specs(plant, kind))
    set_hidden(jctrl, pctrl, seed + 1)
    if valued:
        S = DIMS[PLANTS[plant][0]][0]
        attach_both(jctrl, pctrl, jax_value_net(seed, hiddens=(8,), S=S), scale=VALUE_SCALE)
    return (jctrl, pctrl) + both_params(jctrl)


def both_params(jctrl) -> tuple:
    tree = jax_params_numpy(jctrl)
    return (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree),
            params_from_numpy(tree, CPU))


def raw_emit(opt):
    """Leave the value hook out of ``opt``'s cost kernel: its family then
    returns the emit_terminal form's raw ``(cost, x_H)``."""
    opt._finalize_cost_kernel = lambda raw_call, post: raw_call


def single_inputs(plant: str, Kc: int, seed: int) -> tuple:
    """One session's tiled start state, controls and previous control, in
    both packages' arrays."""
    env = PLANTS[plant][0]
    U = DIMS[env][1]
    rng = np.random.default_rng(seed)
    arrays = (np.repeat(states(plant, rng, 1), Kc, axis=0), controls(env, rng, (Kc, HF, U), 0.8),
              controls(env, rng, (U,), 0.5))
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.tensor, arrays))


def sessions(plant: str, seed: int, Kc: int) -> dict:
    """B sessions' start states (repeated over their rollouts), controls,
    previous controls and targets moved by up to 0.2."""
    env = PLANTS[plant][0]
    S, U = DIMS[env]
    rng = np.random.default_rng(seed)
    attrs = {k: (np.full(B, v, np.float32) + (rng.uniform(-0.2, 0.2, B).astype(np.float32)
                                              if k.startswith("target") else 0.0)
                 ).astype(np.float32)
             for k, v in PLANTS[plant][3].items()}
    s = states(plant, rng, B)
    return {"s": s[:, None], "s0": np.repeat(s, Kc, axis=0),
            "Q": controls(env, rng, (B * Kc, HF, U), 0.8),
            "u_prev": controls(env, rng, (B, U), 0.5), "attrs": attrs}


def port_rows(popt, model, x: dict, params) -> torch.Tensor:
    """The sessions' packed rows ``pvec_b [B, N]`` the port's fleets build."""
    _, slot_keys = split_slot_keys(model.param_keys, ())
    cf = popt.cost_function.cost_function
    return make_slot_packer(model.param_keys, slot_keys, cf.attr_defaults, B, CPU)(
        torch.tensor(x["u_prev"]), params["dyn"], params["cost"],
        {k: torch.tensor(v) for k, v in x["attrs"].items()})


def jax_mppi_cols_kernel(jopt, build: str, Kc: int) -> dict:
    """The session-row kernel a JAX batched MPPI step builds (interpret
    mode, one tile of B*K), captured with its weights and packing."""
    got = {}

    def grab(B_, kernel, weights_fn, shared_keys, slot_keys, dyn_leaves_fn=None, post=None):
        got.update(kernel=kernel, weights=weights_fn, shared=shared_keys, slot=slot_keys)
        return None, None

    jopt._batched_columns_step_from_kernel = grab
    getattr(jopt, build)(B, interpret=True, tile_k=B * Kc)
    return got


def jax_mppi_cols(jopt, jparams, x: dict, build: str, Kc: int, hidden=()):
    """The JAX session-row kernel's output over the sessions ``x``."""
    from control_toolkit_tpu.optimizers.base import make_slot_packer as jax_slot_packer

    got = jax_mppi_cols_kernel(jopt, build, Kc)
    cf = jopt.cost_function.cost_function
    pvec, pslot = jax_slot_packer(got["shared"], got["slot"], cf.attr_defaults, B, Kc)(
        jnp.asarray(x["u_prev"]), jparams["dyn"], jparams["cost"],
        {k: jnp.asarray(v) for k, v in x["attrs"].items()})
    return got["kernel"](jnp.asarray(x["s0"]), jnp.asarray(x["Q"]), pvec, pslot,
                         *got["weights"](jparams["dyn"]), *hidden)


# ---- each form's plain version against the JAX kernel (interpret mode) ---------------------
@pytest.mark.parametrize("valued", [False, True], ids=["plain", "emit"])
@pytest.mark.parametrize("plant", COSTS)
def test_k11_forms_match_pallas_interpret(specs, plant, valued):
    """K11 (valued: its emit_terminal form's costs and x_H) over the cost,
    single-session against ``_build_pallas_neural_cost`` and session-row
    (B sessions, each its own target and previous control) against the
    kernel the JAX batched step builds."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, "mlp", "mppi",
                                              mppi_config(num_rollouts=KS, mpc_horizon=HF),
                                              valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = neural.net_model(popt)
    assert model.plant == plant and neural.can_use_cost(popt)
    S = DIMS[PLANTS[plant][0]][0]
    if valued:
        raw_emit(jopt)
        raw_emit(popt)
    jargs, pargs = single_inputs(plant, KS, 1)
    wrapper = neural_cost_rollout_emit if valued else neural_cost_rollout
    before = wrapper.launches
    ref = jopt._build_pallas_neural_cost(interpret=True, tile_k=KS)(*jargs, jparams)
    got = neural.build_cost(popt)(*pargs, params)
    assert wrapper.launches == before  # CPU tensors: the plain version
    pvec, net = pack(params, pargs[2]), params["dyn"]["net"]
    if valued:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **COST_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **STATE_TOL)
        assert got[1].shape == (KS, S)
        assert torch.equal(got[0], neural_cost_rollout_plain(model, *pargs[:2], pvec, net))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)

    x = sessions(plant, 5, KS)
    ref = jax_mppi_cols(jopt, jparams, x, "_make_batched_neural_step", KS)
    args = (model, torch.tensor(x["s0"]), torch.tensor(x["Q"]), port_rows(popt, model, x, params),
            net)
    if valued:
        c, xh = neural_cost_rollout_cols_emit_plain(*args)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref[0]), **COST_TOL)
        np.testing.assert_allclose(xh.numpy().reshape(-1, S), np.asarray(ref[1]), **STATE_TOL)
        assert torch.equal(c, neural_cost_rollout_cols_emit(*args)[0])
    else:
        c = neural_cost_rollout_cols_plain(*args)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref), **COST_TOL)
        assert torch.equal(c, neural_cost_rollout_cols(*args))
    assert c.shape == (B, KS)


@pytest.mark.parametrize("valued", [False, True], ids=["plain", "emit"])
@pytest.mark.parametrize("plant", COSTS)
def test_k11_member_block_forms_match_pallas_interpret(specs, plant, valued):
    """K11's member-block form (valued: its emit_terminal form) over the
    cost and two stacked members, against ``_build_pallas_ensemble_cost``:
    rollout k under member k // (K/E)."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, "ensemble", "mppi",
                                              mppi_config(num_rollouts=KS, mpc_horizon=HF),
                                              valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = ensemble.net_model(popt)
    assert model.plant == plant and ensemble.can_use_cost(popt)
    if valued:
        raw_emit(jopt)
        raw_emit(popt)
    jargs, pargs = single_inputs(plant, KS, 2)
    ref = jopt._build_pallas_ensemble_cost(interpret=True, tile_k=KS // ENS_MEMBERS)(*jargs,
                                                                                    jparams)
    wrapper = neural_cost_rollout_ens_emit if valued else neural_cost_rollout_ens
    before = wrapper.launches
    got = ensemble.build_cost(popt)(*pargs, params)
    assert wrapper.launches == before
    pvec, net = pack(params, pargs[2]), params["dyn"]["net"]
    if valued:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **COST_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **STATE_TOL)
        plain = neural_cost_rollout_ens_emit_plain(model, *pargs[:2], pvec, net)
        assert torch.equal(got[1], plain[1])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)
        assert torch.equal(got, neural_cost_rollout_ens_plain(model, *pargs[:2], pvec, net))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("plant", COSTS)
def test_k13_forms_match_pallas_interpret(specs, plant, kind):
    """K13 over the cost from a nonzero live hidden: single-session against
    ``_build_pallas_neural_cost``, session-row (each session its own hidden
    rows) against the costs of the JAX batched recurrent step's kernel, and,
    with a value net attached, its emit_terminal form's costs and x_H."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, kind, "mppi",
                                              mppi_config(num_rollouts=KS, mpc_horizon=HF))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = neural.net_model(popt)
    assert model.plant == plant and model.kind == kind and neural.can_use_cost(popt)
    env = PLANTS[plant][0]
    S = DIMS[env][0]
    jargs, pargs = single_inputs(plant, KS, 3)
    before = recurrent_cost_rollout.launches
    ref = jopt._build_pallas_neural_cost(interpret=True, tile_k=KS)(*jargs, jparams)
    got = neural.build_cost(popt)(*pargs, params)
    assert recurrent_cost_rollout.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COST_TOL)
    pvec, dyn = pack(params, pargs[2]), params["dyn"]
    assert torch.equal(got, recurrent_cost_rollout_plain(model, *pargs[:2], pvec, dyn["net"],
                                                         dyn["hidden"]))

    # The session-row form: the JAX batched recurrent step builds its
    # kernel inside the step, so the form's costs are held through one
    # fleet update (each session its own hidden rows).
    before = recurrent_cost_rollout_cols.launches
    mppi_fleet_update(specs, plant, kind)
    assert recurrent_cost_rollout_cols.launches == before

    attach_both(jctrl, pctrl, jax_value_net(5, hiddens=(8,), S=S), scale=VALUE_SCALE)
    jparams, params = both_params(jctrl)
    raw_emit(jopt)
    raw_emit(popt)
    ref_cost, ref_x = jopt._build_pallas_neural_cost(interpret=True, tile_k=KS)(*jargs, jparams)
    before = recurrent_cost_rollout_emit.launches
    cost, x_h = neural.build_cost(popt)(*pargs, params)
    assert recurrent_cost_rollout_emit.launches == before
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **COST_TOL)
    np.testing.assert_allclose(x_h.numpy(), np.asarray(ref_x), **STATE_TOL)
    assert torch.equal(x_h, recurrent_cost_rollout_emit_plain(
        model, *pargs[:2], pvec, dyn["net"], dyn["hidden"])[1])


@pytest.mark.parametrize("valued", [False, True], ids=["plain", "value"])
@pytest.mark.parametrize("plant", COSTS)
def test_k14_and_k10_forms_match_pallas_interpret(monkeypatch, specs, plant, valued):
    """K10 (valued: its value_spec form, V's gradient seeding the backward)
    and K14 (valued: its emit_terminal form) over the cost and a sparse GP,
    single-session against ``_build_pallas_gp_grad`` / ``_gp_cost``, then
    their session-row forms against the kernels the JAX batched binder
    builds (B sessions under their own rows)."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, "gp", "rpgd-tf",
                                              rpgd_config(num_rollouts=KS, mpc_horizon=HF),
                                              valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    model, pack = gp.gp_model(popt)
    assert model.plant == plant and gp.can_use_grad(popt) and gp.can_use_cost(popt)
    assert (popt._value_grad_spec() is not None) == valued
    S = DIMS[PLANTS[plant][0]][0]
    ops = flatten_gp_weights(params["dyn"]["gp"])
    jargs, pargs = single_inputs(plant, KS, 4)
    pvec = pack(params, pargs[2])
    ref_cost, ref_dq = jopt._build_pallas_gp_grad(interpret=True, tile_k=KS)(*jargs, jparams)
    wrapper = gp_grad_cost_rollout_value if valued else gp_grad_cost_rollout
    before = wrapper.launches
    cost, dq = gp.build_grad(popt)(*pargs, params)
    assert wrapper.launches == before
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), **GP_COST_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **GP_GRAD_TOL)
    if valued:  # dV/dx_H seeds the backward: dropping it moves dQ 10x past the error
        unvalued = gp_grad_cost_rollout_plain(model, *pargs[:2], pvec, ops)[1]
        err = np.abs(dq.numpy() - np.asarray(ref_dq)).max()
        assert np.abs(unvalued.numpy() - np.asarray(ref_dq)).max() > 10 * err
        raw_emit(jopt)
        raw_emit(popt)
    ref = jopt._build_pallas_gp_cost(interpret=True, tile_k=KS)(*jargs, jparams)
    got = gp.build_cost(popt)(*pargs, params)
    if valued:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **GP_COST_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **STATE_TOL)
        assert torch.equal(got[1], gp_cost_rollout_emit_plain(model, *pargs[:2], pvec, ops)[1])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GP_COST_TOL)
        assert torch.equal(got, gp_cost_rollout_plain(model, *pargs[:2], pvec, ops))

    fam, caught = jkf.gp, {}
    build = fam.batched_kernels

    def grab(*a, **kw):
        caught["kernels"] = build(*a, **kw)
        return caught["kernels"]

    monkeypatch.setattr(fam, "batched_kernels", grab)
    _, _, jpack = jax_bind_batched(jopt, B, tile_k=B * KS, per_slot_dyn=(), interpret=True)
    gkernel, ckernel, extra_ops = caught["kernels"][:3]
    x = sessions(plant, 8, KS)
    pvec_j, pslot = jpack(jnp.asarray(x["u_prev"]), jparams["dyn"], jparams["cost"],
                          {k: jnp.asarray(v) for k, v in x["attrs"].items()})
    cargs = (jnp.asarray(x["s0"]), jnp.asarray(x["Q"]), pvec_j, pslot, *extra_ops(jparams["dyn"]))
    vops = jopt._flatten_value_ops({"cost": jparams["cost"]}) if valued else ()
    ref_cost, ref_dq = gkernel(*cargs, *vops)
    args = (model, torch.tensor(x["s0"]), torch.tensor(x["Q"]), port_rows(popt, model, x, params),
            ops)
    if valued:
        cost, dq = gp_grad_cost_rollout_cols_value(*args, popt._flatten_value_ops(params))
    else:
        cost, dq = gp_grad_cost_rollout_cols(*args)
    assert cost.shape == (B, KS)
    np.testing.assert_allclose(cost.numpy().reshape(-1), np.asarray(ref_cost), **GP_COST_TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(ref_dq), **GP_GRAD_TOL)
    if not valued:
        assert torch.equal(dq, gp_grad_cost_rollout_cols_plain(*args)[1])
    ref = ckernel(*cargs)
    if valued:
        c, xh = gp_cost_rollout_cols_emit_plain(*args)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref[0]), **GP_COST_TOL)
        np.testing.assert_allclose(xh.numpy().reshape(-1, S), np.asarray(ref[1]), **STATE_TOL)
        assert torch.equal(c, gp_cost_rollout_cols_emit(*args)[0])
    else:
        c = gp_cost_rollout_cols_plain(*args)
        np.testing.assert_allclose(c.numpy().reshape(-1), np.asarray(ref), **GP_COST_TOL)
        assert torch.equal(c, gp_cost_rollout_cols(*args))


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


def mppi_update(specs, plant, kind, valued=False):
    """One MPPI update fed the JAX step's noise: the new plan and control."""
    jctrl, pctrl, _, params = nets_pair(specs, plant, kind, "mppi",
                                        mppi_config(num_rollouts=64, mpc_horizon=HF),
                                        valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    set_mppi_state(jopt, popt)
    s = states(plant, np.random.default_rng(9), 1)[0]
    delta = jax_next_draw(jopt)
    u_jax = jctrl.step(s)
    u, _, diag = popt.update(popt.opt_state, torch.as_tensor(s)[None], params,
                             port_noise(popt, delta))
    np.testing.assert_allclose(diag["u_nom"].numpy(), np.asarray(jopt.opt_state.u_nom), **UNOM_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **UNOM_TOL)


def cem_update(specs, plant, kind):
    """One CEM update (two outer iterations) fed the JAX step's normals: the
    logged costs, the control and the refit distribution."""
    cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": HF, "num_rollouts": 64,
           "cem_outer_it": 2, "cem_initial_action_stdev": 0.5, "cem_stdev_min": 0.01,
           "cem_best_k": 8, "warmup": False, "warmup_iterations": 2}
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, kind, "cem-tf", cfg)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    env = PLANTS[plant][0]
    U = DIMS[env][1]
    rng = np.random.default_rng(1)
    mue = controls(env, rng, (1, HF, U), 0.4)
    std = rng.uniform(0.2, 0.4, (1, HF, U)).astype(np.float32)
    u_prev = controls(env, rng, (U,), 0.3)
    jopt.opt_state = jopt.opt_state._replace(dist_mue=jnp.asarray(mue), stdev=jnp.asarray(std),
                                             count=jnp.asarray(1, jnp.int32),
                                             u_prev=jnp.asarray(u_prev))
    popt.opt_state = CEMState(popt.opt_state.generator, torch.tensor(mue), torch.tensor(std), 1,
                              torch.tensor(u_prev))
    key, draws = jopt.opt_state.key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(np.asarray(jax.random.normal(
            sub, (jopt.num_rollouts, HF, U), jnp.float32))))
    s = states(plant, np.random.default_rng(10), 1)[0]
    u_j, st_j, diag_j = jopt._step_jit(jopt.opt_state, jnp.asarray(s)[None], jparams)
    u, st, diag = popt.update(popt.opt_state, torch.tensor(s)[None], params, draws)
    np.testing.assert_allclose(diag["J_logged"].numpy(), np.asarray(diag_j["J_logged"]),
                               **COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), **UNOM_TOL)
    for name in ("dist_mue", "stdev"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(st_j, name)),
                                   **UNOM_TOL)


def rpgd_update(specs, plant, kind, valued=False):
    """One rpgd-tf update on a resample tick fed the JAX draw: the
    population, the Adam moments and the control."""
    jctrl, pctrl, _, params = nets_pair(specs, plant, kind, "rpgd-tf",
                                        rpgd_config(num_rollouts=KS, mpc_horizon=HF),
                                        valued=valued)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    assert gp.can_use_grad(popt) and (popt._value_grad_spec() is not None) == valued
    rng = np.random.default_rng(0)
    shape = (jopt.num_rollouts, jopt.mpc_horizon, jopt.num_control_inputs)
    Q = controls(PLANTS[plant][0], rng, shape)
    m = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32)
    ages = rng.integers(0, 20, jopt.num_rollouts).astype(np.float32)
    u_prev = np.full(shape[2], 0.2, np.float32)
    jopt.opt_state = jopt.opt_state._replace(
        Q=jnp.asarray(Q), adam=JaxAdamState(step=jnp.int32(4), m=jnp.asarray(m),
                                            v=jnp.asarray(v)),
        trajectory_ages=jnp.asarray(ages), count=jnp.int32(0), u_prev=jnp.asarray(u_prev))
    popt.opt_state = rpgd_state_from_numpy(Q, m, v, 4, ages, 0, u_prev, popt.opt_state.generator)
    s = states(plant, rng, 1)[0]
    draw = torch.as_tensor(jax_rpgd_draw(jopt))
    u_jax = jctrl.step(s)
    u, state, _ = popt.update(popt.opt_state, torch.as_tensor(s)[None], params, draw)
    js = jopt.opt_state
    np.testing.assert_allclose(state.Q.numpy(), np.asarray(js.Q), **Q_TOL)
    np.testing.assert_allclose(state.adam.m.numpy(), np.asarray(js.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(u.numpy(), u_jax, **Q_TOL)


FLEET_STEPS = {"mlp": "_make_batched_neural_step", "gru": "_make_batched_recurrent_step",
               "lstm": "_make_batched_recurrent_step", "gp": "_make_batched_gp_step"}


def mppi_fleet_update(specs, plant, kind):
    """One batched MPPI update (K11's, K13's or K14's session-row form) fed
    the same per-session inputs, hidden states and noise: the costs (the
    JAX kernel's, interpret mode) and the new plans."""
    Kc = 48  # 16-rollout groups straddle the two sessions
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, kind, "mppi",
                                              mppi_config(num_rollouts=Kc, mpc_horizon=HF))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    env = PLANTS[plant][0]
    U = DIMS[env][1]
    x = sessions(plant, 11, Kc)
    rng = np.random.default_rng(12)
    P = jopt.interp.number_of_interpolation_inducing_points
    u_nom = controls(env, rng, (B, 1, HF, U), 0.4)
    delta = (rng.standard_normal((B, Kc, P, U)) * jopt.SQRTRHODTINV).astype(np.float32)
    widths = [h.shape[-1] for h in params["dyn"]["hidden"]] if kind in ("gru", "lstm") else []
    hidden = tuple((0.3 * rng.standard_normal((B, 1, w))).astype(np.float32) for w in widths)
    jstates = JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32), u_nom=jnp.asarray(u_nom),
                           u_prev=jnp.asarray(x["u_prev"]))
    jattrs = {k: jnp.asarray(v) for k, v in x["attrs"].items()}
    jhidden = (tuple(jnp.asarray(h) for h in hidden),) if hidden else ()
    jupdate = getattr(jopt, FLEET_STEPS[kind])(B, interpret=True, tile_k=B * Kc)[1]
    u_ref, c_ref = jupdate(jstates, jnp.asarray(x["s"]), jparams["dyn"], jparams["cost"], jattrs,
                           *jhidden, jnp.asarray(delta))
    update = getattr(popt, FLEET_STEPS[kind])(B)[1]
    pstates = mppi_slot_states_from_numpy(u_nom, x["u_prev"], (None,) * B)
    pattrs = {k: torch.tensor(v) for k, v in x["attrs"].items()}
    phidden = (tuple(torch.tensor(h) for h in hidden),) if hidden else ()
    u_got, costs = update(pstates, torch.tensor(x["s"]), params["dyn"], params["cost"], pattrs,
                          *phidden, torch.tensor(delta))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **FLEET_COST_TOL)
    np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref), **FLEET_UNOM_TOL)


def rpgd_fleet_update(specs, plant, kind):
    """One batched rpgd-tf update over the GP (K10's and K14's session-row
    forms) fed the JAX draw of the slot on its resample tick; the other
    slot keeps."""
    jctrl, pctrl, jparams, params = nets_pair(specs, plant, kind, "rpgd-tf",
                                              rpgd_config(num_rollouts=KS, mpc_horizon=HF))
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = sessions(plant, 19, KS)
    env = PLANTS[plant][0]
    rng = np.random.default_rng(20)
    shape = (B, jopt.num_rollouts, HF, DIMS[env][1])
    p = {"Q": controls(env, rng, shape), "m": (0.05 * rng.standard_normal(shape)).astype(
        np.float32), "v": (0.01 * rng.uniform(0.1, 1.0, shape)).astype(np.float32),
         "ages": rng.integers(0, 20, shape[:2]).astype(np.float32)}
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(B)])
    steps = ADAM_STEPS[:B]
    jstates = JaxRPGDState(
        key=keys, Q=jnp.asarray(p["Q"]),
        adam=JaxAdamState(step=jnp.asarray(steps, jnp.int32), m=jnp.asarray(p["m"]),
                          v=jnp.asarray(p["v"])),
        trajectory_ages=jnp.asarray(p["ages"]), count=jnp.asarray(RPGD_COUNTS, jnp.int32),
        u_prev=jnp.asarray(x["u_prev"]))
    jattrs = {k: jnp.asarray(v) for k, v in x["attrs"].items()}
    jstep = jopt._make_batched_rpgd_step(B, interpret=True, tile_k=B * jopt.num_rollouts)
    ju, jnew, jcosts = jstep(jstates, jnp.asarray(x["s"]), jparams["dyn"], jparams["cost"], jattrs)
    n = jopt.num_rollouts - jopt.opt_keep_k
    dshape = (n, jopt.interp.number_of_interpolation_inducing_points, jopt.num_control_inputs)
    draws = [None if c % jopt.resamp_per else torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(keys[b])[1], dshape, minval=jopt.action_low, maxval=jopt.action_high)))
        for b, c in enumerate(RPGD_COUNTS)]
    pstates = rpgd_slot_states_from_numpy(p["Q"], p["m"], p["v"], steps, p["ages"],
                                          RPGD_COUNTS, x["u_prev"], (None,) * B)
    _, update = popt._make_batched_rpgd_step(B)
    u, new, costs = update(pstates, torch.tensor(x["s"]), params["dyn"], params["cost"],
                           {k: torch.tensor(v) for k, v in x["attrs"].items()}, draws)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), **GP_COST_TOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), **Q_TOL)
    np.testing.assert_allclose(new.Q.numpy(), np.asarray(jnew.Q), **Q_TOL)
    np.testing.assert_allclose(new.adam.m.numpy(), np.asarray(jnew.adam.m), **MOMENT_TOL)
    np.testing.assert_allclose(new.adam.v.numpy(), np.asarray(jnew.adam.v), **MOMENT_TOL)
    np.testing.assert_array_equal(new.count, np.asarray(jnew.count))


# path: (the step, the learned model, its keyword arguments, the forms it
# launches on a card)
PATHS = {
    "mppi_mlp": (mppi_update, "mlp", {}, ("K11",)),
    "mppi_gru": (mppi_update, "gru", {}, ("K13",)),
    "mppi_lstm": (mppi_update, "lstm", {}, ("K13",)),
    "mppi_gp": (mppi_update, "gp", {}, ("K14",)),
    "mppi_ensemble": (mppi_update, "ensemble", {}, ("K11's member-block form",)),
    "valued_mppi_mlp": (mppi_update, "mlp", {"valued": True}, ("K11's emit_terminal form",)),
    "valued_mppi_gp": (mppi_update, "gp", {"valued": True}, ("K14's emit_terminal form",)),
    "cem_mlp": (cem_update, "mlp", {}, ("K11",)),
    "cem_gru": (cem_update, "gru", {}, ("K13",)),
    "cem_lstm": (cem_update, "lstm", {}, ("K13",)),
    "rpgd_gp": (rpgd_update, "gp", {}, ("K10", "K14")),
    "valued_rpgd_gp": (rpgd_update, "gp", {"valued": True},
                       ("K10's value_spec form", "K14's emit_terminal form")),
    "mppi_fleet_mlp": (mppi_fleet_update, "mlp", {}, ("K11's session-row form",)),
    "mppi_fleet_gru": (mppi_fleet_update, "gru", {}, ("K13's session-row form",)),
    "mppi_fleet_gp": (mppi_fleet_update, "gp", {}, ("K14's session-row form",)),
    "rpgd_fleet_gp": (rpgd_fleet_update, "gp", {},
                      ("K10's session-row form", "K14's session-row form")),
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("plant", FLEET_LABELS)
def test_one_update_of_each_path_matches_jax(specs, path, plant):
    """One update of each path over the cost against the JAX package's step
    fed its draws (the forms it launches carry the cost)."""
    step, kind, kwargs, forms = PATHS[path]
    assert all(plant in kernels.KERNEL_PLANTS[form] for form in forms)
    step(specs, plant, kind, **kwargs)


def test_the_forms_carry_the_costs_and_k8_refuses_them():
    """The 17 forms carry the ten cost plants and refuse a fast plant (no
    learned model has fast dynamics); so do K8's six forms, which refuse
    every fast plant's id, naming the kernel and the plant; a GP kernel's
    instance over a cost other than cartpole's takes the kernel's own lanes
    (lanes 0) alone, and a count asked for raises naming the kernel and the
    plant."""
    for form in FORMS:
        assert kernels.KERNEL_PLANTS[form] == kernels.COST_PLANTS
        for plant in COSTS:
            kernels.require(form, plant)
        with pytest.raises(NotImplementedError, match=f"{form} over the 'pendulum_fast'"):
            kernels.require(form, "pendulum_fast")
    assert set(COSTS) | {"cartpole"} == set(kernels.PLANT_DIMS) - set(kernels.FAST_PLANTS.values())
    for form in (f for f in kernels.KERNEL_PLANTS if f.startswith("K8")):
        assert kernels.KERNEL_PLANTS[form] == kernels.COST_PLANTS
        kernels.require(form, "arm2")
        with pytest.raises(NotImplementedError, match=f"{form} over the 'arm2_fast'"):
            kernels.require(form, "arm2_fast")
    model = kernels.GPModel(plant="car", param_keys=kernels.COST_PARAM_KEYS["car"],
                            stage=None, terminal=None, max_cost=1.0)
    s0, Q, pvec = torch.zeros(4, 4), torch.zeros(4, 3, 2), torch.zeros(10)
    with pytest.raises(NotImplementedError, match="K14 at 8 lanes a rollout over the 'car'"):
        gp_cost_rollout_lanes(model, s0, Q, pvec, {}, 8)
    with pytest.raises(NotImplementedError, match="K10 at 16 lanes a rollout over the 'car'"):
        gp_grad_cost_rollout_lanes(model, s0, Q, pvec, {}, 16)


# ---- on a card: every cost's instance of each form against its plain version ---------------
def card_operands(specs, plant: str, kind: str, dev, valued: bool = False):
    """A controller over the cost and the learned model on the card, its
    model, pack and params, and seeded single-session and session-row
    operands (ragged: blocks and 16-rollout groups straddle sessions)."""
    jctrl, pctrl = make_pair(plant, "rpgd-tf" if kind == "gp" else "mppi",
                             rpgd_config(num_rollouts=KS) if kind == "gp" else None,
                             specs(plant, kind))
    set_hidden(jctrl, pctrl, 4)
    tree = jax_params_numpy(jctrl)
    params = params_from_numpy(tree, torch.device(dev))
    popt = pctrl.optimizer
    fam = {"gp": gp, "ensemble": ensemble}.get(kind, neural)
    model, pack = (fam.gp_model if kind == "gp" else fam.net_model)(popt)
    env = PLANTS[plant][0]
    S, U = DIMS[env]
    gen = torch.Generator(device=dev).manual_seed(0)
    low, high = (torch.as_tensor(v, device=dev) for v in limits(env))
    Kc, Hc, Bc, ks = 704, 45, 3, 200
    pvec = pack(params, 0.5 * (low + high)).to(dev)
    rows = pvec.repeat(Bc, 1)
    s0 = torch.as_tensor(states(plant, np.random.default_rng(0), Kc), device=dev)
    Q = low + (high - low) * torch.rand(Kc, Hc, U, generator=gen, device=dev)
    sc = torch.as_tensor(states(plant, np.random.default_rng(1), Bc),
                         device=dev).repeat_interleave(ks, 0)
    Qc = low + (high - low) * torch.rand(Bc * ks, Hc, U, generator=gen, device=dev)
    vg = torch.Generator(device=dev).manual_seed(S)
    vops = [t for d_in, d_out in ((S, 16), (16, 1))
            for t in (torch.randn(d_in, d_out, generator=vg, device=dev) / d_in ** 0.5,
                      0.1 * torch.randn(d_out, generator=vg, device=dev))]
    return model, params, pvec, rows, s0, Q, sc, Qc, vops


def gp_dq_close(got, ref):
    """K10's and K8's dQ against their plain versions: test_torch_plants.py's
    K7 bound, 2e-5 of the largest entry."""
    return float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max()) + 1e-6


def k8_dq_f64_held(got, ref, ref64) -> bool:
    """K8's dQ where the float32 drift of a seeded net at the init's scale
    carries it past K7's bound: no further from the float64 plain version
    ``ref64`` than twice the float32 plain version is, that distance scaled
    by how much further the kernel's J lies from float64 than the plain
    version's (capped at 3), plus 1e-6 of its largest entry, as
    chip_smoke.py's f64_held holds phase 95's instances."""
    def err(a, b):
        return float((a.double() - b).abs().max())

    ratio = min(3.0, max(1.0, err(got[0], ref64[0]) / max(err(ref[0], ref64[0]), 1e-30)))
    return err(got[1], ref64[1]) <= (2.0 * err(ref[1], ref64[1]) * ratio
                                     + 1e-6 * float(ref64[1].abs().max()))


# form group: (the learned model, the forms it holds)
CARD_GROUPS = {
    "k11": ("mlp", ("K11", "K11's emit_terminal form", "K11's session-row form",
                    "K11's session-row emit_terminal form")),
    "k11_members": ("ensemble", ("K11's member-block form",
                                 "K11's member-block emit_terminal form")),
    "k13_gru": ("gru", ("K13", "K13's emit_terminal form", "K13's session-row form")),
    "k13_lstm": ("lstm", ("K13", "K13's emit_terminal form", "K13's session-row form")),
    "k14": ("gp", ("K14", "K14's emit_terminal form", "K14's session-row form",
                   "K14's session-row emit_terminal form")),
    "k10": ("gp", ("K10", "K10's value_spec form", "K10's session-row form",
                   "K10's session-row value_spec form")),
    "k8": ("mlp", ("K8", "K8's value_spec form", "K8's session-row form",
                   "K8's session-row value_spec form")),
    "k8_members": ("ensemble", ("K8's member-block form", "K8's member-block value_spec form")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("group", sorted(CARD_GROUPS))
@pytest.mark.parametrize("plant", COSTS)
def test_cuda_cost_instances_match_plain_versions(cuda_device, specs, plant, group):  # noqa: F811
    """Each cost's instance of each form (K8's too) against its plain
    version on the same card tensors at ragged sizes: costs and J to
    test_torch_kernels.py's tolerance (the nets' to 1e-3 relative: the
    kernels' 3xTF32 products and a recurrent net's hidden carry the
    difference), x_H to STATE_TOL, dQ to K7's bound (K8's, where a seeded
    net's float32 drift carries it past, to float64: k8_dq_f64_held); the
    emit forms' costs equal to their kernels' bit for bit."""
    kind, forms = CARD_GROUPS[group]
    model, params, pvec, rows, s0, Q, sc, Qc, vops = card_operands(specs, plant, kind,
                                                                   cuda_device)
    tol = dict(rtol=1e-4, atol=1e-3) if kind == "gp" else dict(rtol=1e-3, atol=1e-3)
    dyn = params["dyn"]
    if group.startswith("k8"):  # J to the nets' bound, dQ to K7's or float64
        # V at scale 100, as chip_smoke.py's K7 value form holds it, so that
        # its gradient moves dQ past K7's bound over every cost's scale.
        vops = vops[:-2] + [100.0 * vops[-2], 100.0 * vops[-1]]
        # The net's output layer at a tenth of the seeded init's, as
        # chip_smoke.py's NETS_OUT_SCALE takes it: at the init's scale 45
        # steps of the seeded net are chaotic, and two correct float32
        # gradients (the kernel's 3xTF32 products, autograd's float32) drift
        # apart further than any bound float64 gives them.
        last = max(int(k[1:]) for k in dyn["net"] if k.startswith("w") and k[1:].isdigit())
        net = {k: 0.1 * w if k in (f"w{last}", f"b{last}") else w for k, w in dyn["net"].items()}
        single = (model, s0, Q, pvec, net)
        if group == "k8":
            cols = (model, sc, Qc, rows, net)
            runs = ((neural_grad_cost_rollout, neural_grad_cost_rollout_plain, single, ()),
                    (neural_grad_cost_rollout_value, neural_grad_cost_rollout_plain, single,
                     (vops,)),
                    (neural_grad_cost_rollout_cols, neural_grad_cost_rollout_cols_plain, cols, ()),
                    (neural_grad_cost_rollout_cols_value, neural_grad_cost_rollout_cols_plain,
                     cols, (vops,)))
        else:
            runs = ((neural_grad_cost_rollout_ens, neural_grad_cost_rollout_ens_plain, single,
                     ()),
                    (neural_grad_cost_rollout_ens_value, neural_grad_cost_rollout_ens_value_plain,
                     single, (vops,)))
        assert len(runs) == len(forms)
        outs = []
        for kernel, plain, args, v in runs:
            got, ref = kernel(*args, *v), plain(*args, *v)
            torch.testing.assert_close(got[0], ref[0], **tol)
            assert gp_dq_close(got[1], ref[1]) or k8_dq_f64_held(got, ref, plain(
                args[0], *(a.double() for a in args[1:4]),
                {k: w.double() for k, w in args[4].items()}, *[[w.double() for w in vo]
                                                               for vo in v])), (
                kernel.__name__, float((got[1] - ref[1]).abs().max()),
                float(ref[1].abs().max()))
            outs.append(got)
        assert not gp_dq_close(outs[0][1], outs[1][1])  # V reaches dQ
        return
    if kind == "gp":
        ops = flatten_gp_weights(dyn["gp"])
        single, cols = (model, s0, Q, pvec, ops), (model, sc, Qc, rows, ops)
        if group == "k10":
            pairs = ((gp_grad_cost_rollout(*single), gp_grad_cost_rollout_plain(*single)),
                     (gp_grad_cost_rollout_value(*single, vops),
                      gp_grad_cost_rollout_plain(*single, value_ops=vops)),
                     (gp_grad_cost_rollout_cols(*cols), gp_grad_cost_rollout_cols_plain(*cols)),
                     (gp_grad_cost_rollout_cols_value(*cols, vops),
                      gp_grad_cost_rollout_cols_plain(*cols, value_ops=vops)))
            for got, ref in pairs:
                torch.testing.assert_close(got[0], ref[0], **tol)
                assert gp_dq_close(got[1], ref[1])
            assert not gp_dq_close(pairs[0][1][1], pairs[1][1][1])  # V reaches dQ
            return
        runs = ((gp_cost_rollout(*single), gp_cost_rollout_plain(*single)),
                (gp_cost_rollout_emit(*single), gp_cost_rollout_emit_plain(*single)),
                (gp_cost_rollout_cols(*cols), gp_cost_rollout_cols_plain(*cols)),
                (gp_cost_rollout_cols_emit(*cols), gp_cost_rollout_cols_emit_plain(*cols)))
    elif kind == "ensemble":
        single = (model, s0, Q, pvec, dyn["net"])
        runs = ((neural_cost_rollout_ens(*single), neural_cost_rollout_ens_plain(*single)),
                (neural_cost_rollout_ens_emit(*single),
                 neural_cost_rollout_ens_emit_plain(*single)))
    elif kind == "mlp":
        single, cols = (model, s0, Q, pvec, dyn["net"]), (model, sc, Qc, rows, dyn["net"])
        runs = ((neural_cost_rollout(*single), neural_cost_rollout_plain(*single)),
                (neural_cost_rollout_emit(*single), neural_cost_rollout_emit_plain(*single)),
                (neural_cost_rollout_cols(*cols), neural_cost_rollout_cols_plain(*cols)),
                (neural_cost_rollout_cols_emit(*cols),
                 neural_cost_rollout_cols_emit_plain(*cols)))
    else:
        hidden = tuple(h.repeat(rows.shape[0], 1) for h in dyn["hidden"])
        single = (model, s0, Q, pvec, dyn["net"], dyn["hidden"])
        cols = (model, sc, Qc, rows, dyn["net"], hidden)
        runs = ((recurrent_cost_rollout(*single), recurrent_cost_rollout_plain(*single)),
                (recurrent_cost_rollout_emit(*single),
                 recurrent_cost_rollout_emit_plain(*single)),
                (recurrent_cost_rollout_cols(*cols), recurrent_cost_rollout_cols_plain(*cols)))
    assert len(runs) == len(forms)
    for form, (got, ref) in zip(forms, runs):
        if "emit" in form:
            torch.testing.assert_close(got[0], ref[0], **tol)
            torch.testing.assert_close(got[1], ref[1], **STATE_TOL)
        else:
            torch.testing.assert_close(got, ref, **tol)
    emits = [i for i, f in enumerate(forms) if "emit" in f]
    assert torch.equal(runs[emits[0]][0][0], runs[emits[0] - 1][0])  # the same body's costs
