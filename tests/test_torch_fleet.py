"""The port's fleet path against the JAX package: K4 (``ops/mppi_cost_cols.py``),
the batched semi-fused MPPI step and the ``batched-mpc`` controller.

K4's plain version is held to the JAX kernel ``make_run.cols`` in
interpret mode (B=4 sessions, K=64, H=10, JAX tile 128, as
tests/test_pallas_batched.py) with per-session states, targets, previous
controls, nominal plans and pole lengths (``per_slot_dyn=("L",)``), fed the
same noise through the layout map ``eps_from_tiles``: costs to atol 2e-4,
rtol 2e-5 (float32 sums over 10 rk4 steps, test_pallas_batched.py:114).
The port's ``update_from_eps`` is held to JAX's: costs to the same bound,
the new nominal plans to 1e-5 (test_pallas_batched.py:130).  The
controller's own behaviour (independence from B, the mask freeze,
``reset_slot``, ``update_slot_dyn``, the NaN guard, the steps' own refusals
and the configurations the per-slot step now serves) is
checked on the port alone.  K4's plain version at cc_weight 0 equals K1's
plain version over each session's controls (``mppi_controls_plain``).  On
a machine with a card, K4 is held to its plain version, and at ragged B*K
and H=130 to K1 and float64 as chip_smoke.py's ``k4_cases`` holds it.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.optimizers.base import make_slot_packer as jax_slot_packer
from control_toolkit_tpu.optimizers.mppi import MPPIState as JaxMPPIState
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout_plain
from control_toolkit_tpu_torch.ops.interpolation import interpolation_matrix
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_controls_plain
from control_toolkit_tpu_torch.ops.mppi_cost_cols import (
    eps_from_tiles, mppi_cost_cols, mppi_cost_cols_plain, per_rollout,
)
from control_toolkit_tpu_torch.optimizers.base import make_slot_packer, split_slot_keys
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.optimizers.mppi import MPPIState
from control_toolkit_tpu_torch.utils.convert import params_from_numpy
from test_torch_kernels import cuda_device  # noqa: F401  (fixture)
from test_torch_mppi import CPU, LIMITS, optimizer_config

B, K, H, TILE, ROWS = 4, 64, 10, 128, 8
COST_TOL = dict(atol=2e-4, rtol=2e-5)
UNOM_TOL = dict(atol=1e-5, rtol=1e-5)
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    cfg = optimizer_config(K, H)
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.1},
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", optimizer_config=cfg)
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.1},
                          config={"device": "cpu",
                                  "optimizer": "mppi", "controller_logging": False})
    pctrl.configure(optimizer_name="mppi", optimizer_config=cfg)
    return jctrl, pctrl


def fleet_inputs(jopt, seed=7):
    """Per-session states, targets, pole lengths, previous controls and
    nominal plans, and the JAX kernel's noise in its tile layout."""
    rng = np.random.default_rng(seed)
    U = jopt.num_control_inputs
    P = jopt.interp.number_of_interpolation_inducing_points
    T, C = (B * K) // TILE, TILE // ROWS
    return {
        "s": rng.uniform(-0.3, 0.3, (B, 1, 4)).astype(np.float32),
        "target": np.linspace(-0.5, 0.5, B).astype(np.float32),
        "L": np.linspace(0.35, 0.65, B).astype(np.float32),
        "u_prev": rng.uniform(-0.5, 0.5, (B, U)).astype(np.float32),
        "u_nom": rng.uniform(-0.4, 0.4, (B, 1, H, U)).astype(np.float32),
        "eps": rng.normal(0.0, jopt.SQRTRHODTINV, (T, U, P * ROWS, C)).astype(np.float32),
    }


def jax_params(jctrl):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), jctrl._assemble_params())


def port_params(jctrl):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jctrl._assemble_params()), CPU)


def test_k4_plain_matches_pallas_cols(pair):
    """K4's plain version against the JAX kernel ``make_run.cols`` on the
    same per-session operands and noise."""
    jctrl, pctrl = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = fleet_inputs(jopt)
    cps, T, C = K // ROWS, (B * K) // TILE, TILE // ROWS
    _, _, make_run = jopt._build_fused_mppi(build_step=False, interpret=True, tile_k=TILE,
                                            slot_extra_keys=("d_L",))
    jp = jax_params(jctrl)
    pack = jax_slot_packer(make_run.shared_keys, make_run.slot_keys,
                           jopt.cost_function.cost_function.attr_defaults, B)
    pvec, rows = pack(jnp.asarray(x["u_prev"]), dict(jp["dyn"], L=jnp.asarray(x["L"])),
                      jp["cost"], {"target_position": jnp.asarray(x["target"])})

    def expand_cols(vals):  # [B, n] -> [T, n, C], as the JAX step lays them out
        return jnp.repeat(vals, cps, axis=0).reshape(T, C, vals.shape[1]).transpose(0, 2, 1)

    u_nom = np.concatenate([x["u_nom"][:, 0, 1:], x["u_nom"][:, 0, -1:]], axis=1)  # [B, H, U]
    costs2d = make_run.cols(B * K)(pvec, expand_cols(jnp.asarray(x["s"][:, 0])),
                                   expand_cols(jnp.asarray(u_nom.transpose(0, 2, 1).reshape(B, -1))),
                                   expand_cols(rows), jnp.asarray(x["eps"]))
    ref = np.asarray(costs2d).reshape(ROWS, B, cps).transpose(1, 0, 2).reshape(B, K)

    model, _ = ode.rollout_model(popt)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    pp = port_params(jctrl)
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, B, CPU)(
        torch.tensor(x["u_prev"]), dict(pp["dyn"], L=torch.tensor(x["L"])), pp["cost"],
        {"target_position": torch.tensor(x["target"])})
    got = mppi_cost_cols(model, torch.tensor(x["s"][:, 0]), torch.tensor(u_nom), pvec_b,
                         eps_from_tiles(torch.tensor(x["eps"]), B), popt.interp.matrix,
                         popt.action_low, popt.action_high, popt.cc_weight, popt.R, popt.NU)
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.numpy(), ref, **COST_TOL)


def test_update_from_eps_matches_jax(pair):
    """One batched update fed the same noise: costs and new nominal plans."""
    jctrl, pctrl = pair
    jopt, popt = jctrl.optimizer, pctrl.optimizer
    x = fleet_inputs(jopt, seed=11)
    _, jupdate = jopt._make_batched_semi_fused_step(B, interpret=True, tile_k=TILE,
                                                    per_slot_dyn=("L",))
    _, update = popt._make_batched_semi_fused_step(B, per_slot_dyn=("L",))
    jp = jax_params(jctrl)
    jstates = JaxMPPIState(key=jnp.zeros((B, 2), jnp.uint32), u_nom=jnp.asarray(x["u_nom"]),
                           u_prev=jnp.asarray(x["u_prev"]))
    u_ref, c_ref = jupdate(jstates, jnp.asarray(x["s"]), dict(jp["dyn"], L=jnp.asarray(x["L"])),
                           jp["cost"], {"target_position": jnp.asarray(x["target"])},
                           jnp.asarray(x["eps"]))
    pp = port_params(jctrl)
    states = MPPIState(generator=(None,) * B, u_nom=torch.tensor(x["u_nom"]),
                       u_prev=torch.tensor(x["u_prev"]))
    u_nom, costs = update(states, torch.tensor(x["s"]), dict(pp["dyn"], L=torch.tensor(x["L"])),
                          pp["cost"], {"target_position": torch.tensor(x["target"])},
                          eps_from_tiles(torch.tensor(x["eps"]), B))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_ref), **COST_TOL)
    np.testing.assert_allclose(u_nom.numpy(), np.asarray(u_ref), **UNOM_TOL)


def test_eps_from_tiles_follows_the_session_columns():
    """Session b's rollout (r, cw) at inducing point p reads the JAX tile
    layout's row p*8 + r of global column b*K/8 + cw."""
    U, P = 1, 3
    T, C, cps = (B * K) // TILE, TILE // ROWS, K // ROWS
    tiles = torch.arange(T * U * P * ROWS * C, dtype=torch.float32).reshape(T, U, P * ROWS, C)
    eps = eps_from_tiles(tiles, B)
    cols = tiles.permute(1, 2, 0, 3).reshape(U, P * ROWS, T * C)
    for b, p, r, cw in ((0, 0, 0, 0), (1, 2, 7, 3), (3, 1, 5, cps - 1), (2, 0, 1, 6)):
        assert eps[b, p, 0, r * cps + cw] == cols[0, p * ROWS + r, b * cps + cw]


def k4_operands(pctrl, Bc: int, Kc: int, Hc: int, cc_weight: float = 1.0, device=CPU):
    """K4's operands for Bc sessions of Kc rollouts at horizon Hc (inducing
    period 10: P=6 at H=50, P=14 at H=130, three 64-control chunks): pole
    lengths over 0.35-0.65, targets, previous controls, states, plans and
    noise from a seed."""
    popt = pctrl.optimizer
    model, _ = ode.rollout_model(popt)
    gen = torch.Generator(device=device).manual_seed(Hc + Kc)
    W = torch.as_tensor(interpolation_matrix(Hc, 10), device=device)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    params = pctrl._assemble_params()
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, Bc, device)(
        0.3 * torch.randn(Bc, 1, generator=gen, device=device),
        dict({k: v.to(device) for k, v in params["dyn"].items()},
             L=torch.linspace(0.35, 0.65, Bc, device=device)),
        {k: v.to(device) for k, v in params["cost"].items()},
        {"target_position": torch.linspace(-0.1, 0.2, Bc, device=device)})
    s0 = 0.05 * torch.randn(Bc, 4, generator=gen, device=device)
    u_nom = torch.clamp(0.2 * torch.randn(Bc, Hc, 1, generator=gen, device=device), -1.0, 1.0)
    eps = 0.3 * torch.randn(Bc, W.shape[0], 1, Kc, generator=gen, device=device)
    lim = torch.ones(1, device=device)
    return (model, s0, u_nom, pvec_b, eps, W, -lim, lim, cc_weight, popt.R, popt.NU)


def session_controls(args) -> torch.Tensor:
    """Each session's controls [B, K, H, U] (mppi_controls_plain)."""
    _, _, u_nom, _, eps, W, low, high = args[:8]
    return torch.stack([mppi_controls_plain(eps[b], W, u_nom[b], low, high)[0]
                        for b in range(eps.shape[0])])


@pytest.mark.parametrize("Hc", [50, 130])
def test_k4_plain_at_cc_zero_is_k1_plain_per_session(pair, Hc):
    """K2's cc-zero contract for K4, session by session: at cc_weight 0,
    K4's plain version equals K1's plain version over each session's
    mppi_controls_plain controls from its own state under its own
    parameters, bit for bit, so that chip_smoke.py can require the card's
    K4 to equal K1 per session (share 1.0)."""
    args = k4_operands(pair[1], 3, K, Hc, cc_weight=0.0)
    model, s0, _, pvec_b = args[:4]
    Q = session_controls(args)
    via_k1 = torch.stack([cost_rollout_plain(model, s0[b].expand(K, -1), Q[b], pvec_b[b])
                          for b in range(3)])
    assert torch.equal(mppi_cost_cols_plain(*args), via_k1)


OTHER_CONFIGS = {"rpgd-tf": {"outer_its": 2, "period_interpolation_inducing_points": 5},
                 "gradient-tf": {"gradient_steps": 2},
                 "cem-tf": {"cem_outer_it": 2, "cem_best_k": 8}}


def fleet(num_slots=B, optimizer="mppi", per_slot_dyn=("L",), controller_logging=False,
          mesh=None, spec="ODE", **extra):
    """A port batched-mpc controller on the CPU."""
    if optimizer == "mppi":
        cfg = optimizer_config(K, H, **extra)
    else:
        cfg = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K,
               **OTHER_CONFIGS[optimizer], **extra}
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": optimizer, "device": "cpu",
                                        "controller_logging": controller_logging})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec, optimizer_config=cfg,
                   cost_function_config=COST_WEIGHTS, num_slots=num_slots,
                   per_slot_dyn=per_slot_dyn, mesh=mesh)
    return ctrl


def fleet_states(n, seed=3):
    return np.random.default_rng(seed).uniform(-0.2, 0.2, (n, 4)).astype(np.float32)


def test_results_do_not_depend_on_b():
    """Slots 0-1 of a 4-slot fleet and a 2-slot fleet, over three ticks with
    a per-slot target and pole length: the same controls."""
    c4, c2 = fleet(4), fleet(2)
    for c in (c4, c2):
        c.update_slot_dyn(1, {"L": 0.6})
        c.update_slot_attributes(0, {"target_position": 0.2})
    s = fleet_states(4)
    for _ in range(3):
        u4, u2 = c4.step_batch(s), c2.step_batch(s[:2])
        np.testing.assert_allclose(u2, u4[:2], atol=1e-6)
        s = s + 0.01


def generator_states(ctrl):
    return [g.get_state() for g in ctrl.slot_states.generator]


def test_frozen_slots_are_bit_identical_and_emit_zero():
    """A masked-off slot keeps its plan, previous control and random stream
    exactly and commands 0; an active slot's controls do not depend on the
    other slots' masks."""
    ctrl, ref = fleet(), fleet()
    s = fleet_states(B)
    ctrl.step_batch(s)
    ref.step_batch(s)
    before = ctrl.slot_states
    gens = generator_states(ctrl)
    mask = np.array([True, False, True, False])
    u = ctrl.step_batch(s, mask)
    u_all = ref.step_batch(s)
    after = ctrl.slot_states
    assert np.all(u[~mask] == 0.0)
    np.testing.assert_array_equal(u[mask], u_all[mask])
    for i in np.nonzero(~mask)[0]:
        assert torch.equal(after.u_nom[i], before.u_nom[i])
        assert torch.equal(after.u_prev[i], before.u_prev[i])
        assert torch.equal(ctrl.slot_states.generator[i].get_state(), gens[i])
    for i in np.nonzero(mask)[0]:
        assert not torch.equal(after.u_nom[i], before.u_nom[i])
        assert not torch.equal(ctrl.slot_states.generator[i].get_state(), gens[i])


def test_reset_slot_replays_the_initial_stream():
    ctrl = fleet()
    s = fleet_states(B)
    first = [ctrl.step_batch(s) for _ in range(2)]
    ctrl.reset_slot(2)
    again = [ctrl.step_batch(s) for _ in range(2)]
    for a, b in zip(first, again):
        assert a[2] == b[2]
    assert not np.array_equal(first[0][1], again[0][1])  # the others went on
    ctrl.controller_reset()
    np.testing.assert_array_equal(ctrl.step_batch(s), first[0])


def test_update_slot_dyn_validates_before_committing(caplog):
    ctrl = fleet(per_slot_dyn=("L", "m_pole"))
    L0, m0 = ctrl.slot_dyn["L"].copy(), ctrl.slot_dyn["m_pole"].copy()
    with pytest.raises(ValueError, match="finite"):
        ctrl.update_slot_dyn(1, {"L": 0.7, "m_pole": float("nan")})
    with pytest.raises(ValueError, match="finite"):
        ctrl.update_slot_dyn(1, {"L": None})
    np.testing.assert_array_equal(ctrl.slot_dyn["L"], L0)
    np.testing.assert_array_equal(ctrl.slot_dyn["m_pole"], m0)
    with caplog.at_level(logging.WARNING):
        ctrl.update_slot_dyn(1, {"L": 0.7, "g": 9.0})
    assert "'g' was not named in per_slot_dyn" in caplog.text
    assert ctrl.slot_dyn["L"][1] == np.float32(0.7) and ctrl.slot_dyn["L"][0] == L0[0]
    ctrl.reset_slot_dyn(1)
    np.testing.assert_array_equal(ctrl.slot_dyn["L"], L0)
    with pytest.raises(ValueError, match="not a scalar dynamics constant"):
        fleet(per_slot_dyn=("length",))


def test_per_slot_dyn_changes_the_plan_without_a_rebuild():
    """Two slots in one state, one planning against another pole length:
    their controls differ, and nothing was rebuilt."""
    ctrl = fleet(num_slots=2)
    epoch = ctrl.optimizer._build_epoch
    s = np.repeat(fleet_states(1), 2, axis=0)
    same = ctrl.step_batch(s)
    ctrl.controller_reset()
    ctrl.update_slot_dyn(1, {"L": 0.3})
    ctrl.reset_slot(1)
    ctrl.reset_slot(0)
    differ = ctrl.step_batch(s)
    assert same[0] == differ[0] and same[1] != differ[1]
    assert ctrl.optimizer._build_epoch == epoch


def test_nan_guard_resets_only_the_bad_slot():
    ctrl = fleet()
    s = fleet_states(B)
    ctrl.step_batch(s)
    poisoned = ctrl.slot_states.u_nom.clone()
    poisoned[2] = float("nan")
    ctrl.slot_states = ctrl.slot_states._replace(u_nom=poisoned)
    kept = ctrl.slot_states.u_nom.clone()
    u = ctrl.step_batch(s)
    assert u[2] == 0.0 and np.all(np.isfinite(u))
    fresh = fleet().slot_states
    assert torch.equal(ctrl.slot_states.u_nom[2], fresh.u_nom[2])
    assert torch.equal(ctrl.slot_states.generator[2].get_state(), fresh.generator[2].get_state())
    for i in (0, 1, 3):
        assert not torch.equal(ctrl.slot_states.u_nom[i], kept[i])
        assert torch.isfinite(ctrl.slot_states.u_nom[i]).all()


def test_scalar_step_drives_slot_0():
    ctrl, ref = fleet(), fleet()
    s = fleet_states(B)
    u0 = ctrl.step(s[0])
    mask = np.zeros(B, bool)
    mask[0] = True
    np.testing.assert_array_equal(u0, ref.step_batch(s, mask)[0])


@pytest.mark.parametrize("kind", [
    "force_scan", "logging", "mesh", "rpgd-tf", "gradient-tf", "cem-modular", "value_terminal",
    "cem_warmup",
])
def test_unported_batched_configurations_raise(kind):
    """The slot mesh raises NotImplementedError, and so do the kernel
    steps' own refusals (the JAX package's: a valued or warmup fused-CEM
    step); every other configuration that no batched kernel step serves
    (force_scan, logging, RPGD and gradient-tf with warmup, modular CEM, a
    valued fused-CEM fleet) now takes the per-slot step, each active slot
    equal to its single-session controller bit for bit
    (tests/test_torch_fleet_per_slot.py)."""
    from test_torch_fleet_per_slot import assert_slots_equal_single
    from test_torch_fleet_per_slot import build as build_per_slot

    builds = {
        "force_scan": lambda: fleet(force_scan=True),
        "logging": lambda: fleet(controller_logging=True),
        # The gradient fleets take their kernel steps
        # (tests/test_torch_fleet_grad.py); with warmup on, the per-slot step.
        "rpgd-tf": lambda: fleet(optimizer="rpgd-tf", per_slot_dyn=(), warmup=True,
                                 warmup_iterations=2),
        "gradient-tf": lambda: fleet(optimizer="gradient-tf", per_slot_dyn=(), warmup=True,
                                     warmup_iterations=2),
        "cem-modular": lambda: fleet(optimizer="cem-tf", per_slot_dyn=()),
    }
    if kind == "mesh":
        with pytest.raises(NotImplementedError, match="slot mesh"):
            fleet(mesh=object())
        return
    if kind in builds:
        assert_slots_equal_single(builds[kind]())
        return
    cem = fleet(optimizer="cem-tf", per_slot_dyn=(), fully_fused=True)
    if kind == "value_terminal":
        # The MPPI fleet over the ODE carries a post hook (K4's emit_terminal
        # form, tests/test_torch_value.py); K6 carries none (its step
        # refuses, as JAX's), so a valued fully-fused CEM fleet takes the
        # per-slot step.
        cf = cem.optimizer.cost_function.cost_function
        cf.post_terminal_cost = lambda x, params: x[:, 0]
        with pytest.raises(NotImplementedError):
            cem.optimizer._make_batched_fused_cem_step(2)
        assert not cem._batched_fused_cem_eligible() and cem._kernel_kind() is None
        valued = build_per_slot("value_cem_fused", BatchedMPCController, num_slots=2)
        assert_slots_equal_single(valued)
        return
    cem.optimizer.warmup = True
    with pytest.raises(NotImplementedError):
        cem.optimizer._make_batched_fused_cem_step(2)


LEARNED_FLEETS = {
    "mlp": ("neural:mlp-64-64:{assets}", (), "neural_rollout", "neural_cost_rollout_cols"),
    "gru": ("neural:GRU-5IN-32H1-32H2-4OUT:{assets}", (), "neural_rollout",
            "recurrent_cost_rollout_cols"),
    "residual": ("ODE+res", ("L",), "residual_rollout", "residual_cost_rollout_cols"),
    "gp": ("SGP_128:{assets}/SGP_128.npz", (), "gp_rollout", "gp_cost_rollout_cols"),
}


@pytest.mark.parametrize("kind", list(LEARNED_FLEETS))
def test_learned_fleets_build_on_their_cols_kernels(kind, monkeypatch):
    """MPPI fleets over the committed MLP, GRU and GP and over "ODE+res"
    (per-slot pole lengths) build, and a tick scores every session in one
    call of the model's session-row kernel (on CPU tensors its plain
    version)."""
    import importlib

    from control_toolkit_tpu_torch.ops import kernels

    spec, per_slot_dyn, module, wrapper = LEARNED_FLEETS[kind]
    mod = importlib.import_module(f"control_toolkit_tpu_torch.ops.{module}")
    calls, kernel = [], getattr(mod, wrapper)

    def spy(*args):
        calls.append(args[3].shape[0])  # the sessions' rows pvec_b [B, N]
        return kernel(*args)

    monkeypatch.setattr(mod, wrapper, spy)
    ctrl = fleet(per_slot_dyn=per_slot_dyn,
                 spec=spec.format(assets=kernels.PACKAGE_DIR / "assets" / "cartpole"))
    u = ctrl.step_batch(fleet_states(B))
    assert calls == [B] and u.shape == (B, 1) and np.all(np.isfinite(u))


@pytest.mark.cuda
def test_cuda_k4_matches_plain_version(pair, cuda_device):
    """K4 against its plain version on the same card tensors (B*K not a
    multiple of the block: the edge is masked)."""
    _, pctrl = pair
    popt = pctrl.optimizer
    model, _ = ode.rollout_model(popt)
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    Bc, Kc, Hc, P = 3, 1000, 50, 6
    W = torch.as_tensor(interpolation_matrix(Hc, 10), device=dev)
    _, slot_keys = split_slot_keys(model.param_keys, ("L",))
    params = pctrl._assemble_params()
    pvec_b = make_slot_packer(model.param_keys, slot_keys, {}, Bc, dev)(
        0.3 * torch.randn(Bc, 1, generator=gen, device=dev),
        dict({k: v.to(dev) for k, v in params["dyn"].items()},
             L=torch.tensor([0.35, 0.5, 0.65], device=dev)),
        {k: v.to(dev) for k, v in params["cost"].items()},
        {"target_position": torch.tensor([-0.1, 0.0, 0.2], device=dev)})
    s0 = 0.05 * torch.randn(Bc, 4, generator=gen, device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(Bc, Hc, 1, generator=gen, device=dev), -1.0, 1.0)
    eps = 0.3 * torch.randn(Bc, P, 1, Kc, generator=gen, device=dev)
    lim = torch.ones(1, device=dev)
    args = (model, s0, u_nom, pvec_b, eps, W, -lim, lim, popt.cc_weight, popt.R, popt.NU)
    got = mppi_cost_cols(*args)
    assert got.shape == (Bc, Kc)
    torch.testing.assert_close(got, mppi_cost_cols_plain(*args), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_cuda_k4_at_ragged_sessions_and_a_long_horizon(pair, cuda_device):
    """K4 (mppi_ahead.cuh's body, rows by session) at 3 sessions of K=1000
    (blocks straddle sessions) within KERNEL_TOL of its plain version at
    H=50; at cc_weight 0 equal to K1 per session at H=50 and H=130 (three
    64-control chunks); at H=130 within chip_smoke.py's float64 bounds
    (long_horizon_vs_float64, which must reject the bracket restarted at a
    chunk's head, and corr_vs_float64 at the path's cc_weight)."""
    from chip_smoke import (
        KERNEL_TOL, as_type, corr_vs_float64, k1_per_session, k3_mutant_controls,
        long_horizon_vs_float64,
    )

    dev = cuda_device
    Bc, Kc = 3, 1000
    args = k4_operands(pair[1], Bc, Kc, 50, device=dev)
    torch.testing.assert_close(mppi_cost_cols(*args), mppi_cost_cols_plain(*args), **KERNEL_TOL)
    for Hc in (50, 130):
        args = k4_operands(pair[1], Bc, Kc, Hc, 0.0, device=dev)
        model, s0, u_nom, pvec_b, eps, W, low, high = args[:8]
        got = mppi_cost_cols(*args).reshape(-1)
        Q = session_controls(args)
        via_k1 = k1_per_session(model, s0, Q, pvec_b).reshape(-1)
        assert torch.equal(got, via_k1)
        if Hc == 130:
            restarted = torch.stack([k3_mutant_controls(
                eps[b], W, u_nom[b], low, high, "bracket_restarted_each_chunk")[0]
                for b in range(Bc)])
            long_horizon_vs_float64(
                model, per_rollout(s0, Kc).T, Q.reshape(Bc * Kc, Hc, 1), per_rollout(pvec_b, Kc),
                {"k4": got, "k1": via_k1},
                {"bracket_restarted_each_chunk": restarted.reshape(Bc * Kc, Hc, 1)})
            full = k4_operands(pair[1], Bc, Kc, Hc, pair[1].optimizer.cc_weight, device=dev)
            corr_vs_float64("K4", mppi_cost_cols(*full), mppi_cost_cols_plain(*full),
                            mppi_cost_cols_plain(*as_type(full, torch.float64)))
