"""The port's checkpoints (``utils/checkpoint.py``) on the CPU.

The file format is the JAX package's (``leaf_{i}``, ``__n_leaves``,
``__paths`` as ``jax.tree_util.keystr`` writes them: checked against JAX on
the same tree), a generator saved as its ``get_state()`` bytes.  Each round
trip resumes exactly: an rpgd-tf controller's Adam moments and counters
(``save_optimizer``, ``save_controller`` with its attributes), and
``save_fleet`` / ``load_fleet`` of an rpgd-tf fleet over per-slot pole
lengths (stacked state, numpy counters), an MPPI fleet over a GRU (the
slots' hiddens) and a per-slot CEM fleet (a list of states), each loaded
into a fresh controller whose next ticks equal the uninterrupted one's bit
for bit (the counterpart of tests/test_fleet_checkpoint.py without the
server).  A checkpoint of another configuration, shape or dtype is
refused; a JAX checkpoint's structure is not the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.utils import checkpoint as jax_checkpoint
from control_toolkit_tpu_torch.controllers.batched_mpc import BatchedMPCController
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.optimizers.rpgd import RPGDState
from control_toolkit_tpu_torch.utils import checkpoint
from test_torch_fleet_per_slot import same, snapshot

LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
H = 8
CONFIGS = {
    "rpgd-tf": {"seed": 7, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 32,
                "outer_its": 2, "warmup": False, "resamp_per": 2,
                "period_interpolation_inducing_points": 4},
    "mppi": {"seed": 7, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 32,
             "SQRTRHOINV": 0.05, "period_interpolation_inducing_points": 4},
    "cem-tf": {"seed": 7, "mpc_timestep": 0.02, "mpc_horizon": H, "num_rollouts": 32,
               "cem_outer_it": 2, "cem_best_k": 8, "warmup": False},
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def controller(optimizer: str, cls=MPCController, spec: str = "ODE", **configure):
    ctrl = cls("cartpole", LIMITS, {"target_position": 0.1},
               config={"optimizer": optimizer, "device": "cpu", "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=dict(CONFIGS[optimizer]), cost_function_config=COST_WEIGHTS,
                   **configure)
    return ctrl


def states(B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.2, 0.2, (B, 4)).astype(np.float32)


def test_the_file_format_is_the_jax_packages(tmp_path):
    """The same tree (dicts, a list, a record) saved by both packages: the
    same keys, leaf count, paths and leaves; the port restores it onto the
    template's kinds, a generator by its state."""
    from typing import NamedTuple

    class Rec(NamedTuple):
        a: np.ndarray
        b: np.ndarray

    tree = {"x": [Rec(np.arange(3, dtype=np.float32), np.ones((2, 2), np.int32))],
            "y": (np.float32(2.5) * np.ones(1, np.float32),)}
    jax_checkpoint.save_state(tmp_path / "jax.npz", jax.tree_util.tree_map(jnp.asarray, tree))
    checkpoint.save_state(tmp_path / "port.npz", tree)
    j, p = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(j.files) == sorted(p.files)
    for key in j.files:
        np.testing.assert_array_equal(j[key], p[key])
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    live = {"g": gen, "t": torch.arange(4.0), "n": np.zeros(2, np.int64), "c": 7}
    checkpoint.save_state(tmp_path / "gen", live)  # no extension: np.savez adds it
    back = checkpoint.load_state(tmp_path / "gen", {"g": torch.Generator(), "t": torch.zeros(4),
                                                   "n": np.ones(2, np.int64), "c": 0})
    assert torch.equal(torch.rand(3, generator=back["g"]), torch.rand(3, generator=gen))
    assert torch.equal(back["t"], live["t"]) and back["c"] == 7 and back["n"].dtype == np.int64


def test_mismatched_checkpoints_are_refused(tmp_path):
    """Another leaf count, another structure (paths), shape or dtype kind:
    ValueError; a JAX optimizer checkpoint (its PRNG key where the port has
    a generator) does not load into the port."""
    path = tmp_path / "s.npz"
    checkpoint.save_state(path, {"a": np.zeros(3, np.float32), "b": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(path, {"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_state(path, {"a": np.zeros(3, np.float32), "c": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(path, {"a": np.zeros(4, np.float32), "b": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_state(path, {"a": np.zeros(3, bool), "b": np.zeros(2, np.float32)})
    from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC

    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.1},
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", optimizer_config=dict(CONFIGS["mppi"]))
    jax_checkpoint.save_optimizer(tmp_path / "jax_opt.npz", jctrl.optimizer)
    with pytest.raises(ValueError):
        checkpoint.load_optimizer(tmp_path / "jax_opt.npz", controller("mppi").optimizer)


def test_rpgd_optimizer_and_controller_round_trips(tmp_path):
    """Two ticks, a checkpoint, four more: a fresh controller loaded from the
    checkpoint steps the same four ticks bit for bit, its Adam moments, step
    counters, ages and generator equal after the load (``save_optimizer``);
    ``save_controller`` carries the attributes too."""
    ctrl = controller("rpgd-tf")
    ctrl.update_attributes({"target_position": -0.3})
    s = states(6, 1)
    for t in range(2):
        ctrl.step(s[t])
    checkpoint.save_optimizer(tmp_path / "opt.npz", ctrl.optimizer)
    checkpoint.save_controller(tmp_path / "ctrl.npz", ctrl)
    saved = snapshot(ctrl.optimizer.opt_state)
    go_on = [ctrl.step(s[t]) for t in range(2, 6)]
    for load in ("opt", "ctrl"):
        fresh = controller("rpgd-tf")
        if load == "opt":
            fresh.update_attributes({"target_position": -0.3})
            checkpoint.load_optimizer(tmp_path / "opt.npz", fresh.optimizer)
        else:
            checkpoint.load_controller(tmp_path / "ctrl.npz", fresh)
            assert float(fresh.variable_parameters["target_position"]) == np.float32(-0.3)
        st = fresh.optimizer.opt_state
        assert isinstance(st, RPGDState) and same(snapshot(st), saved)
        assert st.count == 2 and isinstance(st.count, int)
        resumed = [fresh.step(s[t]) for t in range(2, 6)]
        np.testing.assert_array_equal(np.stack(resumed), np.stack(go_on))


FLEETS = {
    "rpgd_per_slot_dyn": ("rpgd-tf", "ODE", {"per_slot_dyn": ("L",)}),
    "gru_mppi": ("mppi", "neural:GRU-5IN-8H1-4OUT", {}),
    "cem_per_slot": ("cem-tf", "ODE", {"per_slot_dyn": ("L",)}),
}


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_round_trip_resumes_bit_for_bit(tmp_path, case):
    """A fleet's every slot state, hidden, attribute and per-slot constant:
    saved after two ticks (one slot frozen on the second), loaded into a
    freshly configured fleet, whose next three ticks equal the
    uninterrupted fleet's bit for bit."""
    optimizer, spec, kw = FLEETS[case]
    B = 3
    fleet = controller(optimizer, BatchedMPCController, spec, num_slots=B, **kw)
    if kw.get("per_slot_dyn"):
        fleet.update_slot_dyn(1, {"L": 0.65})
    fleet.update_slot_attributes(2, {"target_position": -0.2})
    assert fleet._per_slot == (case == "cem_per_slot")
    fleet.step_batch(states(B, 0))
    fleet.step_batch(states(B, 1), np.array([True, False, True]))
    checkpoint.save_fleet(tmp_path / "fleet.npz", fleet)
    go_on = [fleet.step_batch(states(B, t)) for t in range(2, 5)]
    hidden_after = [h.clone() for h in fleet.slot_hidden] if fleet._stateful else []

    fresh = controller(optimizer, BatchedMPCController, spec, num_slots=B, **kw)
    checkpoint.load_fleet(tmp_path / "fleet.npz", fresh)
    if kw.get("per_slot_dyn"):
        assert fresh.slot_dyn["L"][1] == np.float32(0.65)
        fresh.slot_dyn["L"][0] = fresh.slot_dyn["L"][0]  # writable rows
    assert fresh.slot_attrs["target_position"][2] == np.float32(-0.2)
    resumed = [fresh.step_batch(states(B, t)) for t in range(2, 5)]
    np.testing.assert_array_equal(np.stack(resumed), np.stack(go_on))
    for a, b in zip(hidden_after, getattr(fresh, "slot_hidden", ())):
        assert torch.equal(a, b) and torch.any(a != 0.0)


def test_fleet_load_rejects_a_mismatched_configuration(tmp_path):
    """A checkpoint of 3 slots into a 2-slot fleet, of an MPPI fleet into an
    rpgd-tf fleet, of a kernel-path fleet into a per-slot one: refused."""
    mppi3 = controller("mppi", BatchedMPCController, num_slots=3)
    checkpoint.save_fleet(tmp_path / "f.npz", mppi3)
    for other in (controller("mppi", BatchedMPCController, num_slots=2),
                  controller("rpgd-tf", BatchedMPCController, num_slots=3),
                  controller("cem-tf", BatchedMPCController, num_slots=3)):
        with pytest.raises(ValueError):
            checkpoint.load_fleet(tmp_path / "f.npz", other)
