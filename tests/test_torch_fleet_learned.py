"""The port's learned fleets against the JAX package: ``batched-mpc``
serving plain MPPI sessions over an MLP (K11), a GRU or LSTM (K13), the
residual ``"ODE+res"`` (K12) and a sparse GP (K14), all B sessions'
rollouts in one launch of the kernel's session-row form.

Each learned fleet's ``update_from_eps`` is held to the JAX step's
(``_make_batched_{neural,recurrent,residual,gp}_step``, its kernel in
interpret mode with one tile of B*K rollouts) on the same per-session
states, targets, previous controls, nominal plans, hidden states (the
recurrent nets), pole lengths (``"ODE+res"`` with ``per_slot_dyn=("L",)``)
and noise ``delta_b [B, K, P, U]``: costs to atol 2e-4, rtol 2e-5, the new
plans to 1e-5 (tests/test_torch_fleet.py's bounds), at K=64 and at K=120,
where 16-rollout groups straddle sessions.  Each session-row plain version
equals its single-session plain version session by session; the results
do not depend on B; a GRU slot follows a single ``mpc`` controller; the
mask freezes a slot's hidden bit for bit and ``reset_slot`` zeroes one
slot's hidden alone; the gates choose each model's step and the rest is
refused by name.  On a machine with a card, each session-row kernel is
held to its plain version at K=512 and K=120 (``-m cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.environments.cartpole import CartpoleEnv as JaxCartpoleEnv
from control_toolkit_tpu.models import gp_predictor as jgp
from control_toolkit_tpu.models import networks as jnets
from control_toolkit_tpu.models.training import collect_transitions as jax_collect
from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.gp_rollout import (
    flatten_gp_weights, gp_cost_rollout_cols, gp_cost_rollout_cols_plain, gp_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    neural_cost_rollout_cols, neural_cost_rollout_cols_plain, neural_cost_rollout_plain,
    recurrent_cost_rollout_cols, recurrent_cost_rollout_cols_plain, recurrent_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.residual_rollout import (
    residual_cost_rollout_cols, residual_cost_rollout_cols_plain, residual_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural, residual
from control_toolkit_tpu_torch.utils.convert import (
    mppi_slot_states_from_numpy, params_from_numpy, slot_hidden_from_numpy,
)
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, LIMITS, optimizer_config
from test_torch_neural import jax_net
from test_torch_residual import bench_residual

H = 10
COST_TOL = dict(atol=2e-4, rtol=2e-5)
UNOM_TOL = dict(atol=1e-5, rtol=1e-5)
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
# The learned models: a net's name (a JAX-initialised net, saved by the
# JAX package), "ODE+res" (the same nonzero residual in both) or "gp" (a
# small GP the JAX package fits).
NETS = {"mlp": "mlp-16-16", "gru": "GRU-5IN-16H1-8H2-4OUT", "lstm": "LSTM-5IN-16H1-4OUT"}
CASES = ("mlp", "gru", "lstm", "residual", "gp")
GP_M = 16


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    """Each case's predictor specification over checkpoints the JAX package
    wrote."""
    root = tmp_path_factory.mktemp("learned")
    out = {}
    for i, (case, name) in enumerate(NETS.items()):
        jnets.save_net(root / f"{name}.npz", jax_net(name, seed=i + 1, norms=case == "mlp"),
                       meta={"predict_delta": True})
        out[case] = f"neural:{name}:{root}"
    x, u, xn = jax_collect(JaxCartpoleEnv(batch_size=8, dt=0.02, seed=0), 40, seed=0)
    params, _ = jgp.fit_gp_dynamics(x, u, xn, num_inducing=GP_M, seed=0)
    jgp.GPPredictor("cartpole", dt=0.02, params=params).save(root / "sgp.npz")
    out["gp"] = f"SGP_{GP_M}:{root / 'sgp.npz'}"
    out["residual"] = "ODE+res"
    return out


def make_pair(spec: str, Kc: int):
    """The JAX and the port ``mpc`` controller over ``spec`` (the residual
    with the same nonzero weights in both)."""
    cfg = optimizer_config(Kc, H)
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.3},
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", predictor_specification=spec,
                    optimizer_config=dict(cfg))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.3},
                          config={"device": "cpu", "optimizer": "mppi",
                                  "controller_logging": False})
    pctrl.configure(optimizer_name="mppi", predictor_specification=spec,
                    optimizer_config=dict(cfg))
    if spec == "ODE+res":
        jpred = jctrl.optimizer.predictor.predictor
        res = bench_residual(jpred._res)
        jpred.set_residual(res)
        jctrl._dyn_params = None
        pctrl.optimizer.predictor.predictor.set_residual(res)
    return jctrl, pctrl


def hidden_widths(pctrl) -> list:
    """The state width of each cell of a recurrent net (the LSTM's [h, c])."""
    pred = pctrl.optimizer.predictor.predictor
    return [h.shape[-1] for h in pred.hidden] if pred.is_stateful else []


def fleet_inputs(popt, B: int, Kc: int, widths, seed: int) -> dict:
    """Per-session states, targets, pole lengths, previous controls, plans,
    hidden states and the modular-layout noise ``[B, K, P, U]``."""
    rng = np.random.default_rng(seed)
    P = popt.interp.number_of_interpolation_inducing_points

    def f32(a):
        return np.asarray(a, np.float32)

    return {
        "s": f32(rng.uniform(-0.3, 0.3, (B, 1, 4))),
        "target": f32(np.linspace(-0.5, 0.5, B)),
        "L": f32(np.linspace(0.35, 0.65, B)),
        "u_prev": f32(rng.uniform(-0.5, 0.5, (B, 1))),
        "u_nom": f32(rng.uniform(-0.4, 0.4, (B, 1, H, 1))),
        "delta": f32(rng.normal(0.0, popt.SQRTRHODTINV, (B, Kc, P, 1))),
        "hidden": tuple(f32(rng.normal(0.0, 0.3, (B, 1, w))) for w in widths),
    }


def with_slot_dyn(dyn: dict, case: str, L):
    """``dyn`` with the sessions' pole lengths in the residual's base."""
    return dict(dyn, base=dict(dyn["base"], L=L)) if case == "residual" else dyn


def jax_update(case: str, jopt, B: int, tile: int):
    if case == "mlp":
        return jopt._make_batched_neural_step(B, interpret=True, tile_k=tile)[1]
    if case in ("gru", "lstm"):
        return jopt._make_batched_recurrent_step(B, interpret=True, tile_k=tile)[1]
    if case == "residual":
        return jopt._make_batched_residual_step(B, interpret=True, tile_k=tile,
                                                per_slot_dyn=("L",))[1]
    return jopt._make_batched_gp_step(B, interpret=True, tile_k=tile)[1]


def port_update(case: str, popt, B: int):
    if case == "mlp":
        return popt._make_batched_neural_step(B)[1]
    if case in ("gru", "lstm"):
        return popt._make_batched_recurrent_step(B)[1]
    if case == "residual":
        return popt._make_batched_residual_step(B, per_slot_dyn=("L",))[1]
    return popt._make_batched_gp_step(B)[1]


@pytest.mark.parametrize("Kc", [64, 120])
@pytest.mark.parametrize("case", CASES)
def test_update_from_eps_matches_jax(specs, case, Kc):
    """One batched update fed the same per-session inputs and noise: the
    costs and the new nominal plans, against the JAX step with its kernel
    in interpret mode."""
    B = 4
    jctrl, pctrl = make_pair(specs[case], Kc)
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = fleet_inputs(popt, B, Kc, hidden_widths(pctrl), seed=Kc + len(case))
    jp = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), jctrl._assemble_params())
    jstates = JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32), u_nom=jnp.asarray(x["u_nom"]),
                           u_prev=jnp.asarray(x["u_prev"]))
    jargs = (jstates, jnp.asarray(x["s"]), with_slot_dyn(jp["dyn"], case, jnp.asarray(x["L"])),
             jp["cost"], {"target_position": jnp.asarray(x["target"])})
    jhidden = (tuple(jnp.asarray(h) for h in x["hidden"]),) if x["hidden"] else ()
    u_ref, c_ref = jax_update(case, jopt, B, B * Kc)(*jargs, *jhidden, jnp.asarray(x["delta"]))

    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jctrl._assemble_params()), CPU)
    states = mppi_slot_states_from_numpy(x["u_nom"], x["u_prev"], (None,) * B)
    pargs = (states, torch.tensor(x["s"]), with_slot_dyn(pp["dyn"], case, torch.tensor(x["L"])),
             pp["cost"], {"target_position": torch.tensor(x["target"])})
    phidden = (slot_hidden_from_numpy(x["hidden"], CPU),) if x["hidden"] else ()
    u_nom, costs = port_update(case, popt, B)(*pargs, *phidden, torch.tensor(x["delta"]))
    assert costs.shape == (B, Kc) and u_nom.shape == (B, H, 1)
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **COST_TOL)
    np.testing.assert_allclose(u_nom.numpy(), np.asarray(u_ref), **UNOM_TOL)


def cols_problem(case: str, pctrl, B: int, Kc: int, seed: int = 5):
    """A session-row form's operands on the CPU: ``(cols, cols_plain,
    single_plain, operands, per_session)`` with ``per_session(b)`` session
    b's single-session operands."""
    popt = pctrl.optimizer
    gen = torch.Generator().manual_seed(seed)
    pred = popt.predictor.predictor
    params = pctrl._assemble_params()
    if case == "residual":
        model, _ = residual.residual_model(popt)
        dyn = dict(params["dyn"]["base"], L=torch.linspace(0.35, 0.65, B))
        slot = ("L",)
    elif case == "gp":
        model, _ = gp.gp_model(popt)
        dyn, slot = params["dyn"], ()
    else:
        model, _ = neural.net_model(popt)
        dyn, slot = params["dyn"], ()
    _, slot_keys = split_slot_keys(model.param_keys, slot)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, CPU)(
        0.3 * torch.randn(B, 1, generator=gen), dyn, params["cost"],
        {"target_position": torch.linspace(-0.2, 0.2, B)})
    s0 = (0.05 * torch.randn(B, 4, generator=gen)).repeat_interleave(Kc, dim=0)
    Q = torch.clamp(0.3 * torch.randn(B * Kc, H, 1, generator=gen), -1.0, 1.0)

    def rows(b):
        return s0[b * Kc:(b + 1) * Kc], Q[b * Kc:(b + 1) * Kc], pvec_b[b]

    if case == "residual":
        net = params["dyn"]["res"]
        return (residual_cost_rollout_cols, residual_cost_rollout_cols_plain,
                residual_cost_rollout_plain, (model, s0, Q, pvec_b, net),
                lambda b: (model, *rows(b), net))
    if case == "gp":
        ops = flatten_gp_weights(params["dyn"]["gp"])
        return (gp_cost_rollout_cols, gp_cost_rollout_cols_plain, gp_cost_rollout_plain,
                (model, s0, Q, pvec_b, ops), lambda b: (model, *rows(b), ops))
    net = params["dyn"]["net"]
    if not pred.recurrent:
        return (neural_cost_rollout_cols, neural_cost_rollout_cols_plain,
                neural_cost_rollout_plain, (model, s0, Q, pvec_b, net),
                lambda b: (model, *rows(b), net))
    hidden_b = tuple(0.3 * torch.randn(B, h.shape[-1], generator=gen) for h in pred.hidden)
    return (recurrent_cost_rollout_cols, recurrent_cost_rollout_cols_plain,
            recurrent_cost_rollout_plain, (model, s0, Q, pvec_b, net, hidden_b),
            lambda b: (model, *rows(b), net, tuple(h[b:b + 1] for h in hidden_b)))


@pytest.mark.parametrize("case", CASES)
def test_cols_plain_is_the_single_session_plain_version_per_session(specs, case):
    """Each session-row plain version, over 3 sessions of K=120 (the
    wrapper on CPU tensors), equals the single-session plain version run
    with session b's row (and hidden) over its rollouts, to float32
    rounding of a batched matmul."""
    B, Kc = 3, 120
    cols, cols_plain, single, args, per_session = cols_problem(case, make_pair(specs[case], Kc)[1],
                                                               B, Kc)
    got = cols(*args)
    assert got.shape == (B, Kc) and torch.equal(got, cols_plain(*args))
    ref = torch.stack([single(*per_session(b)) for b in range(B)])
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-5)


def fleet(spec: str, num_slots: int, per_slot_dyn=(), optimizer="mppi", Kc=64, **extra):
    """A port batched-mpc controller over ``spec`` on the CPU."""
    if optimizer == "mppi":
        cfg = optimizer_config(Kc, H, **extra)
    else:
        cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": Kc,
               "outer_its": 2, **extra}
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "device": "cpu",
                                        "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec, optimizer_config=cfg,
                   cost_function_config=COST_WEIGHTS, num_slots=num_slots,
                   per_slot_dyn=per_slot_dyn)
    if spec == "ODE+res":
        pred = ctrl.optimizer.predictor.predictor
        gen = torch.Generator().manual_seed(11)
        pred.set_residual({k: 0.02 * torch.randn(v.shape, generator=gen)
                           if k.startswith("w") else v for k, v in pred._res.items()})
    return ctrl


def fleet_of(specs, case: str, num_slots: int, **kw):
    return fleet(specs[case], num_slots, ("L",) if case == "residual" else (), **kw)


def states(n, seed=3):
    return np.random.default_rng(seed).uniform(-0.2, 0.2, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_results_do_not_depend_on_b(specs, case):
    """Slots 0-1 of a 4-slot fleet and of a 2-slot fleet, over three ticks
    with a per-slot target (and pole length): the same controls."""
    c4, c2 = fleet_of(specs, case, 4), fleet_of(specs, case, 2)
    for c in (c4, c2):
        c.update_slot_attributes(0, {"target_position": 0.2})
        if case == "residual":
            c.update_slot_dyn(1, {"L": 0.6})
    s = states(4)
    for _ in range(3):
        u4, u2 = c4.step_batch(s), c2.step_batch(s[:2])
        np.testing.assert_allclose(u2, u4[:2], atol=1e-6)
        s = s + 0.01


def test_gru_slot_matches_a_single_mpc_controller(specs):
    """A GRU fleet's slot 2 against a single ``mpc`` controller started from
    the slot's generator, over four ticks: the controls, and the hidden the
    slot carried against the single predictor's."""
    B, slot = 3, 2
    batched = fleet_of(specs, "gru", B)
    single = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                           config={"optimizer": "mppi", "device": "cpu",
                                   "controller_logging": False})
    single.configure(optimizer_name="mppi", predictor_specification=specs["gru"],
                     optimizer_config=optimizer_config(64, H), cost_function_config=COST_WEIGHTS)
    single.optimizer.opt_state = single.optimizer._init_state(batched._slot_generator(slot))
    s = np.array([0.1, 0.0, 0.2, -0.1], np.float32)
    for _ in range(4):
        u_b = batched.step_batch(np.tile(s, (B, 1)))
        u_s = single.step(s)
        np.testing.assert_allclose(u_b[slot], u_s, atol=5e-5)
        s = s + 0.01
    for h_slot, h_single in zip(batched.slot_hidden, single.optimizer.predictor.predictor.hidden):
        torch.testing.assert_close(h_slot[slot], h_single, rtol=0, atol=5e-5)
        assert torch.any(h_slot[slot] != 0.0), "the hidden never advanced"


@pytest.mark.parametrize("case", ["gru", "lstm"])
def test_mask_freezes_a_slots_hidden_bit_for_bit(specs, case):
    ctrl = fleet_of(specs, case, 4)
    s = np.tile(np.array([0.0, 0.0, 0.2, 0.0], np.float32), (4, 1))
    ctrl.step_batch(s)  # every hidden off zero
    before = [h.clone() for h in ctrl.slot_hidden]
    mask = np.array([True, False, True, False])
    ctrl.step_batch(s, mask)
    for b, a in zip(before, ctrl.slot_hidden):
        assert torch.equal(b[1], a[1]) and torch.equal(b[3], a[3])
        assert not torch.equal(b[0], a[0]) and not torch.equal(b[2], a[2])


def test_reset_slot_zeroes_one_slots_hidden_alone(specs):
    ctrl = fleet_of(specs, "gru", 3)
    ctrl.step_batch(np.tile(np.array([0.0, 0.0, 0.2, 0.0], np.float32), (3, 1)))
    keep = [h[0].clone() for h in ctrl.slot_hidden]
    assert all(torch.any(k != 0.0) for k in keep)
    ctrl.reset_slot(1)
    for h, k in zip(ctrl.slot_hidden, keep):
        assert torch.all(h[1] == 0.0) and torch.equal(h[0], k)
    ctrl.controller_reset()
    assert all(torch.all(h == 0.0) for h in ctrl.slot_hidden)


def test_nan_guard_resets_the_bad_slots_plan_and_hidden_alone(specs):
    ctrl = fleet_of(specs, "gru", 4)
    s = states(4)
    ctrl.step_batch(s)
    poisoned = ctrl.slot_states.u_nom.clone()
    poisoned[2] = float("nan")
    ctrl.slot_states = ctrl.slot_states._replace(u_nom=poisoned)
    kept = [h.clone() for h in ctrl.slot_hidden]
    u = ctrl.step_batch(s)
    assert u[2] == 0.0 and np.all(np.isfinite(u))
    for h, k in zip(ctrl.slot_hidden, kept):
        assert torch.all(h[2] == 0.0) and torch.isfinite(h).all()
        assert all(not torch.equal(h[i], k[i]) for i in (0, 1, 3))


GATES = {"mlp": "_batched_neural_eligible", "gru": "_batched_recurrent_eligible",
         "lstm": "_batched_recurrent_eligible", "residual": "_batched_residual_eligible",
         "gp": "_batched_gp_eligible"}


@pytest.mark.parametrize("case", CASES)
def test_gates_choose_each_models_step(specs, case):
    """Exactly the model's own gate admits the fleet, the recurrent nets
    carry a per-slot hidden and the step draws its noise in the modular
    layout [K, P, U]."""
    ctrl = fleet_of(specs, case, 2)
    admitted = {name for name in set(GATES.values()) | {"_batched_kernel_eligible",
                                                        "_batched_fused_cem_eligible"}
                if getattr(ctrl, name)()}
    assert admitted == {GATES[case]}
    assert ctrl._stateful == (case in ("gru", "lstm"))
    opt = ctrl.optimizer
    assert opt._slot_noise_shape == (64, opt.interp.number_of_interpolation_inducing_points, 1)
    if ctrl._stateful:
        widths = [h.shape[-1] for h in opt.predictor.predictor.hidden]
        assert [tuple(h.shape) for h in ctrl.slot_hidden] == [(2, 1, w) for w in widths]


@pytest.mark.parametrize("kind", ["value_terminal", "rpgd-tf", "gradient-tf", "force_scan",
                                  "bounded_update", "per_slot_dyn_mlp", "per_slot_dyn_gru",
                                  "per_slot_dyn_gp"])
def test_what_the_learned_fleets_leave_out_is_refused(specs, kind):
    """A learned value terminal over a recurrent net and the vmapped
    per-slot step (force_scan, a variant's update, an RPGD fleet over a
    recurrent net, a gradient fleet with warmup; the gradient fleets are
    otherwise served, tests/test_torch_fleet_grad.py, and so are the valued
    MLP, "ODE+res" and GP fleets, tests/test_torch_value_learned.py) raise
    NotImplementedError naming the piece; ``per_slot_dyn`` over a net or a
    GP, which have no scalar dynamics constants, is a ValueError as in the
    JAX package."""
    if kind.startswith("per_slot_dyn"):
        with pytest.raises(ValueError, match="not a scalar dynamics constant"):
            fleet(specs[kind.rsplit("_", 1)[1]], 2, ("L",))
        return
    if kind == "value_terminal":
        ctrl = fleet_of(specs, "gru", 2)
        cf = ctrl.optimizer.cost_function.cost_function
        cf.post_terminal_cost = lambda x, params: x[:, 0]
        assert not any(getattr(ctrl, gate)() for gate in set(GATES.values()))
        assert "value terminal" in str(ctrl._refusal())
        with pytest.raises(NotImplementedError, match="vmapped per-slot"):
            ctrl.optimizer._make_batched_recurrent_step(2)
        return
    build, match = {
        "rpgd-tf": (lambda: fleet(specs["gru"], 2, optimizer="rpgd-tf"), "rpgd-tf"),
        "gradient-tf": (lambda: fleet(specs["gp"], 2, optimizer="gradient-tf", warmup=True),
                        "gradient-tf with warmup"),
        "force_scan": (lambda: fleet(specs["gru"], 2, force_scan=True), "vmapped"),
        "bounded_update": (lambda: fleet(specs["residual"], 2, bounded_update=True), "vmapped"),
    }[kind]
    with pytest.raises(NotImplementedError, match=match):
        build()


def test_slot_states_and_hidden_carry_across_from_numpy():
    gens = tuple(torch.Generator().manual_seed(i) for i in range(2))
    st = mppi_slot_states_from_numpy(np.ones((2, 1, H, 1)), np.zeros((2, 1)), gens)
    assert st.generator == gens and st.u_nom.dtype == torch.float32
    assert tuple(st.u_nom.shape) == (2, 1, H, 1) and tuple(st.u_prev.shape) == (2, 1)
    hidden = slot_hidden_from_numpy((np.ones((2, 1, 8)), np.zeros((2, 1, 4))), CPU)
    assert [tuple(h.shape) for h in hidden] == [(2, 1, 8), (2, 1, 4)]


# ---- on the card ------------------------------------------------------------
def card_problem(case: str, B: int, Kc: int, device):
    """A session-row form's operands on the card, over the committed net or
    GP (the GRU; the LSTM seeded; the residual seeded nonzero; the GP's
    posterior weights redrawn, chip_smoke.py's well-conditioned GP), with
    chip_smoke.py's tolerance for its kernel."""
    from chip_smoke import (
        GP_SPEC, GRU_SPEC, LSTM_SPEC, MLP_SPEC, NET_TOL, RNN_TOL, well_conditioned_gp,
    )

    spec = {"mlp": MLP_SPEC, "gru": GRU_SPEC, "lstm": LSTM_SPEC, "residual": "ODE+res",
            "gp": GP_SPEC}[case]
    ctrl = fleet(spec, B, ("L",) if case == "residual" else (), Kc=Kc)
    if case == "gp":
        pred = ctrl.optimizer.predictor.predictor
        pred.gp_params = well_conditioned_gp(pred.gp_params)
    cols, _, _, args, _ = cols_problem(case, ctrl, B, Kc)
    args = tuple(kernels_to(a, device) for a in args)
    return cols, args, RNN_TOL if case in ("gru", "lstm") else NET_TOL


def kernels_to(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, dict):
        return {k: kernels_to(v, device) for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(kernels_to(v, device) for v in a)
    return a


PLAIN = {neural_cost_rollout_cols: neural_cost_rollout_cols_plain,
         recurrent_cost_rollout_cols: recurrent_cost_rollout_cols_plain,
         residual_cost_rollout_cols: residual_cost_rollout_cols_plain,
         gp_cost_rollout_cols: gp_cost_rollout_cols_plain}


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [512, 120])
@pytest.mark.parametrize("case", CASES)
def test_cuda_cols_kernels_match_plain_versions(cuda_device, case, Kc):
    """Each session-row kernel against its plain version on the same card
    tensors, 3 sessions of K=512 and of K=120 (16-rollout groups straddle
    sessions), within its single-session kernel's bound."""
    cols, args, tol = card_problem(case, 3, Kc, cuda_device)
    got = cols(*args)
    assert got.shape == (3, Kc) and torch.isfinite(got).all()
    torch.testing.assert_close(got, PLAIN[cols](*args), **tol)
