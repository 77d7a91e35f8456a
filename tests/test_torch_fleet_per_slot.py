"""The batched controller's per-slot step (``controllers/batched_mpc.py``
``_step_slots``, the counterpart of JAX ``batched_mpc.py:391-401``) on the
CPU.

Every configuration that no batched kernel step serves (each one the
controller refused before: modular CEM, warmup, every cem-gmm, cma-es,
cem-naive-grad, cem-grad-bharadhwaj and ilqr fleet, a gradient fleet over a
recurrent net, an ensemble fleet, a valued fused-CEM or recurrent MPPI
fleet, a gradient fleet whose value net is not a plain tanh MLP,
mppi-optimize, bounded_update, modular mppi-var, force_scan, logging, the
optimal trajectory) steps, and each active slot equals its single-session
controller started from the slot's generator, bit for bit, tick after
tick, while a frozen slot's state and generator stay exactly as they were
and it commands 0.  A recurrent fleet's hidden advances in one batched cell
step (its rows an ulp from a batch-1 step's), so the single-session
controller is handed the slot's hidden before each tick.  The slot mesh
alone is refused; the kernel-path fleets keep their kernel steps.
"""
import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.costs.value_terminal import attach_value_terminal
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.utils.checkpoint import _as_array, _flatten

LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
ASSETS = kernels.PACKAGE_DIR / "assets" / "cartpole"
K, H = 32, 8
BASE = {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": K}
MPPI = {**BASE, "SQRTRHOINV": 0.05, "period_interpolation_inducing_points": 4}
RPGD = {**BASE, "outer_its": 2, "period_interpolation_inducing_points": 4}

# label: (optimizer, predictor specification, config, controller config, value net kind)
PER_SLOT = {
    "cem_modular": ("cem-tf", "ODE", {**BASE, "cem_outer_it": 2, "cem_best_k": 8,
                                      "warmup": False}, {}, None),
    "cem_warmup": ("cem-tf", "ODE", {**BASE, "cem_outer_it": 1, "cem_best_k": 8,
                                     "warmup": True, "warmup_iterations": 2,
                                     "fully_fused": True}, {}, None),
    "rpgd_warmup": ("rpgd-tf", "ODE", {**RPGD, "warmup": True, "warmup_iterations": 2}, {},
                    None),
    "gradient_warmup": ("gradient-tf", "ODE", {**BASE, "gradient_steps": 2, "warmup": True,
                                               "warmup_iterations": 2}, {}, None),
    "rpgd_gru": ("rpgd-tf", "neural:GRU-5IN-8H1-4OUT", {**RPGD, "warmup": False}, {}, None),
    "force_scan": ("mppi", "ODE", {**MPPI, "force_scan": True}, {}, None),
    "logging": ("mppi", "ODE", MPPI, {"controller_logging": True}, None),
    "optimal_trajectory": ("mppi", "ODE", MPPI, {"calculate_optimal_trajectory": True}, None),
    "mppi_optimize": ("mppi", "ODE", {**MPPI, "optim_steps": 2, "mppi_LR": 0.05}, {}, None),
    "bounded_update": ("mppi", "ODE", {**MPPI, "bounded_update": True}, {}, None),
    "mppi_var_modular": ("mppi-var-tf", "ODE", {**BASE, "semi_fused": False}, {}, None),
    "cem_gmm": ("cem-gmm-tf", "ODE", {**BASE, "cem_outer_it": 1, "cem_best_k": 8}, {}, None),
    "cma_es": ("cma-es-tf", "ODE", {**BASE, "cma_outer_it": 1}, {}, None),
    "cem_naive_grad": ("cem-naive-grad-tf", "ODE", {**BASE, "cem_best_k": 8}, {}, None),
    "cem_grad_bharadhwaj": ("cem-grad-bharadhwaj-tf", "ODE", {**BASE, "cem_best_k": 8}, {},
                            None),
    "ilqr": ("ilqr", "ODE", {"seed": 3, "mpc_timestep": 0.02, "mpc_horizon": H,
                             "num_rollouts": 1, "max_iterations": 3}, {}, None),
    "ensemble_mppi": ("mppi", f"ensemble:mlp-32-32:4:{ASSETS}", MPPI, {}, None),
    "ensemble_rpgd": ("rpgd-tf", f"ensemble:mlp-32-32:4:{ASSETS}", {**RPGD, "warmup": False},
                      {}, None),
    "value_cem_fused": ("cem-tf", "ODE", {**BASE, "num_rollouts": 64, "fully_fused": True,
                                          "warmup": False, "cem_outer_it": 1,
                                          "cem_best_k": 8}, {}, "plain"),
    "value_gru_mppi": ("mppi", "neural:GRU-5IN-8H1-4OUT", MPPI, {}, "plain"),
    "value_rpgd_norms": ("rpgd-tf", "ODE", {**RPGD, "warmup": False}, {}, "norms"),
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def value_net(kind: str) -> dict:
    """A seeded tanh V 4-8-1 (``"norms"``: with an input norm, which no
    value_spec form takes)."""
    g = torch.Generator().manual_seed(5)
    net = {"w0": 0.3 * torch.randn(4, 8, generator=g), "b0": 0.1 * torch.randn(8, generator=g),
           "w1": 0.3 * torch.randn(8, 1, generator=g), "b1": torch.zeros(1)}
    if kind == "norms":
        net["norm_in_mean"] = torch.zeros(4)
        net["norm_in_std"] = torch.ones(4)
    return net


def build(label: str, cls, **configure):
    optimizer, spec, cfg, ctrl_cfg, value = PER_SLOT[label]
    ctrl = cls("cartpole", LIMITS, {"target_position": 0.1},
               config={"optimizer": optimizer, "device": "cpu", "controller_logging": False,
                       **ctrl_cfg})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=dict(cfg), cost_function_config=COST_WEIGHTS, **configure)
    if value is not None:
        attach_value_terminal(ctrl, value_net(value), value_scale=2.0)
    return ctrl


def snapshot(state) -> list:
    return [_as_array(leaf).copy() for _, leaf in _flatten(state)]


def same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def single_like(fleet) -> MPCController:
    """An ``mpc`` controller configured as ``fleet`` was (its stashed
    configure call, its attributes and, where attached, its value net)."""
    args, kwargs = fleet._configure_stash
    kwargs = {k: v for k, v in kwargs.items() if k not in ("num_slots", "per_slot_dyn")}
    single = MPCController(fleet.environment_name, fleet.control_limits,
                           {k: v.clone() for k, v in fleet.variable_parameters.items()},
                           config=dict(fleet.config_controller))
    single.configure(*args, **kwargs)
    res = getattr(fleet.optimizer.predictor.predictor, "_res", None)
    if res is not None:  # "ODE+res": the fleet's residual weights
        single.optimizer.predictor.predictor.set_residual(res)
    holder = getattr(fleet, "_value_holder", None)
    if holder:
        attach_value_terminal(single, holder["params"], holder["scale"])
    return single


def assert_slots_equal_single(fleet, single=None, masks=None, seed=0) -> None:
    """Step ``fleet`` under each mask in turn (by default all slots, then
    slot 1 frozen, then slot 0): each active slot's control equals
    ``single``'s (an ``mpc`` controller configured as the fleet,
    ``single_like``'s by default) stepped from that slot's own state, bit
    for bit; a frozen slot commands 0 and keeps its state and generator
    exactly."""
    B = fleet.num_slots
    assert fleet._per_slot and fleet._kstep is None
    single = single_like(fleet) if single is None else single
    if masks is None:
        masks = (np.ones(B, bool), np.arange(B) != 1, np.arange(B) != 0)
    opt = single.optimizer
    refs = [opt._init_state(fleet._slot_generator(i)) for i in range(B)]
    rng = np.random.default_rng(seed)
    S = opt.num_states
    for mask in masks:
        mask = np.asarray(mask, bool)
        s = rng.uniform(-0.2, 0.2, (B, S)).astype(np.float32)
        before = [snapshot(st) for st in fleet.slot_states]
        hidden = [h.clone() for h in fleet.slot_hidden] if fleet._stateful else None
        u = fleet.step_batch(s, mask)
        for i in range(B):
            if not mask[i]:
                assert np.all(u[i] == 0.0) and same(snapshot(fleet.slot_states[i]), before[i])
                continue
            opt.opt_state = refs[i]
            if hidden is not None:
                opt.predictor.predictor.hidden = tuple(h[i].clone() for h in hidden)
            np.testing.assert_array_equal(u[i], single.step(s[i]))
            refs[i] = opt.opt_state
            assert same(snapshot(fleet.slot_states[i]), snapshot(refs[i]))
        if hidden is not None:
            for h_new, h_old in zip(fleet.slot_hidden, hidden):
                assert torch.equal(h_new[~torch.as_tensor(mask)], h_old[~torch.as_tensor(mask)])
                assert not torch.equal(h_new[torch.as_tensor(mask)], h_old[torch.as_tensor(mask)])


@pytest.mark.parametrize("label", sorted(PER_SLOT))
def test_each_active_slot_equals_its_single_session_controller(label):
    """The configuration takes the per-slot step (no kernel gate admits it)
    and each active slot equals its single-session controller bit for bit,
    over three ticks with a slot frozen on each of the last two."""
    fleet = build(label, BatchedMPCController, num_slots=3)
    assert fleet._kernel_kind() is None
    assert isinstance(fleet.slot_states, list) and len(fleet.slot_states) == 3
    assert_slots_equal_single(fleet, build(label, MPCController))
    if label == "cem_modular":
        assert_slots_equal_single(build(label, BatchedMPCController, num_slots=2))


def test_per_slot_reset_nan_guard_and_controller_reset():
    """``reset_slot`` gives the slot its initial state alone; a slot whose
    plan turned NaN commands 0 and is reset alone; ``controller_reset``
    starts every slot over on its stream."""
    fleet = build("cem_modular", BatchedMPCController, num_slots=3)
    s = np.random.default_rng(1).uniform(-0.2, 0.2, (3, 4)).astype(np.float32)
    first = fleet.step_batch(s)
    kept = snapshot(fleet.slot_states[0])
    fleet.reset_slot(1)
    fresh = fleet.optimizer._init_state(fleet._slot_generator(1))
    assert same(snapshot(fleet.slot_states[1]), snapshot(fresh))
    assert same(snapshot(fleet.slot_states[0]), kept)
    st = fleet.slot_states[2]
    fleet.slot_states[2] = st._replace(dist_mue=torch.full_like(st.dist_mue, float("nan")))
    u = fleet.step_batch(s)
    assert u[2] == 0.0 and u[1] == first[1] and np.all(np.isfinite(u))
    assert same(snapshot(fleet.slot_states[2]),
                snapshot(fleet.optimizer._init_state(fleet._slot_generator(2))))
    fleet.controller_reset()
    np.testing.assert_array_equal(fleet.step_batch(s), first)


def test_per_slot_fleet_with_per_slot_dyn_and_attrs():
    """``per_slot_dyn`` and per-slot attributes reach each slot's step as
    0-d tensors: slot i equals a single-session controller configured with
    slot i's pole length and target, bit for bit."""
    fleet = build("cem_modular", BatchedMPCController, num_slots=2, per_slot_dyn=("L",))
    fleet.update_slot_dyn(1, {"L": 0.7})
    fleet.update_slot_attributes(1, {"target_position": -0.2})
    single = build("cem_modular", MPCController)
    single.predictor.predictor._defaults["L"] = 0.7
    single.update_attributes({"target_position": -0.2})
    single.optimizer.opt_state = single.optimizer._init_state(fleet._slot_generator(1))
    s = np.random.default_rng(2).uniform(-0.2, 0.2, (2, 4)).astype(np.float32)
    for _ in range(2):
        u = fleet.step_batch(s)
        np.testing.assert_array_equal(u[1], single.step(s[1]))


def test_the_mesh_alone_is_refused_and_kernel_fleets_keep_their_steps():
    """``_refusal`` names the slot mesh alone (ROADMAP A10); a fleet that a
    kernel gate admits keeps its batched kernel step and stacked state."""
    ctrl = BatchedMPCController("cartpole", LIMITS, {"target_position": 0.0},
                                config={"optimizer": "mppi", "device": "cpu",
                                        "controller_logging": False})
    err = ctrl._refusal()
    assert isinstance(err, NotImplementedError) and "slot mesh" in str(err)
    for kw in ({"mesh": object()}, {"slot_axis": "slots"}):
        with pytest.raises(NotImplementedError, match="slot mesh"):
            ctrl.configure(optimizer_name="mppi", optimizer_config=MPPI, num_slots=2, **kw)
    ctrl.configure(optimizer_name="mppi", optimizer_config=MPPI, num_slots=2,
                   cost_function_config=COST_WEIGHTS)
    assert ctrl._kernel_kind() == "ode" and not ctrl._per_slot
    assert ctrl.slot_states.u_nom.shape == (2, 1, H, 1)
