"""Guards for the torch port that run on a machine without a card: it
never imports jax (its controllers, fleets, closed loops, grid search and
checkpoints driven with jax blocked), a CUDA device, named or the default, never falls back
to the CPU, and chip_smoke.py fails (and prints no result) where there is
no card."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0, "cc_weight": 1.0,
                "ccrc_weight": 1.0, "R": 1.0}

NO_JAX_DRIVE = r"""
import sys
sys.modules["jax"] = None  # any 'import jax' now raises ImportError
import numpy as np, torch
torch.set_num_threads(1)
from control_toolkit_tpu_torch import import_controller_by_name
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
Ctrl = import_controller_by_name("mppi")
for semi in (True, False):
    ctrl = Ctrl("cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
                {"target_position": 0.0},
                config={"optimizer": "mppi", "controller_logging": False, "device": "cpu"})
    ctrl.configure(optimizer_name="mppi", optimizer_config={
        "seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 10, "num_rollouts": 32,
        "period_interpolation_inducing_points": 5, "semi_fused": semi},
        cost_function_config={"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                              "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0})
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=0)
    s, _ = env.reset()
    for _ in range(3):
        u = ctrl.step(s[0])
        s, *_ = env.step(u)
    assert np.all(np.isfinite(u)) and u.shape == (1,)
ctrl = import_controller_by_name("rpgd-tf")(
    "cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
    {"target_position": 0.0},
    config={"optimizer": "rpgd-tf", "controller_logging": False, "device": "cpu"})
ctrl.configure(optimizer_name="rpgd-tf", optimizer_config={
    "seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 10, "num_rollouts": 32,
    "period_interpolation_inducing_points": 5, "resamp_per": 2},
    cost_function_config={"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                          "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0})
s, _ = CartpoleEnv(batch_size=1, dt=0.02, seed=0).reset()
for _ in range(3):
    u = ctrl.step(s[0])
assert np.all(np.isfinite(u)) and u.shape == (1,)
import os, tempfile
from control_toolkit_tpu_torch.evaluation import ClosedLoop, grid_search
from control_toolkit_tpu_torch.utils import checkpoint
loop = ClosedLoop(ctrl, CartpoleEnv(batch_size=1, dt=0.02, seed=0))
assert np.isfinite(loop.run(s[0], 2)["mean_cost"])
assert loop.run_batch(np.tile(s, (2, 1)), 2)["mean_costs"].shape == (2,)
res = grid_search(loop, {"attrs.target_position": np.array([0.0, 0.1], np.float32)}, s[0], 2)
assert len(res["configs"]) == 2
fleet = import_controller_by_name("batched-mpc")(
    "cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
    {"target_position": 0.0},
    config={"optimizer": "cem-tf", "controller_logging": False, "device": "cpu"})
fleet.configure(optimizer_name="cem-tf", num_slots=2, optimizer_config={
    "seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 10, "num_rollouts": 32, "cem_best_k": 8},
    cost_function_config={"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                          "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0})
assert fleet._per_slot and fleet.step_batch(np.tile(s, (2, 1))).shape == (2, 1)
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_fleet(os.path.join(d, "f"), fleet)
    checkpoint.load_fleet(os.path.join(d, "f"), fleet)
    checkpoint.save_controller(os.path.join(d, "c"), ctrl)
    checkpoint.load_controller(os.path.join(d, "c"), ctrl)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "control_toolkit_tpu"))
assert loaded == ["jax"], loaded  # only the blocked placeholder
print("NO_JAX_OK")
"""


def run_python(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_and_steps_without_jax():
    res = run_python(["-c", NO_JAX_DRIVE], REPO)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX_OK" in res.stdout


def test_port_sources_never_import_jax():
    """Neither jax nor the JAX package, in the port or in chip_smoke.py."""
    foreign = re.compile(r"^\s*(import jax|from jax|import control_toolkit_tpu\b(?!_)"
                         r"|from control_toolkit_tpu\b(?!_))")
    paths = [*(REPO / "control_toolkit_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            assert not foreign.match(line), f"{path}: {line}"


def test_chip_smoke_binds_each_top_level_name_once():
    """A second top-level def, class, assignment or import of one name in
    chip_smoke.py would silently replace the first for every phase that
    calls it."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    lines = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            bound = [node.name]
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            bound = [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound = [(a.asname or a.name).split(".")[0] for a in node.names]
        else:
            continue
        for name in bound:
            lines.setdefault(name, []).append(node.lineno)
    twice = {name: at for name, at in lines.items() if len(at) > 1}
    assert not twice, f"bound more than once at the top level: {twice}"


NO_JAX_NEURAL_DRIVE = r"""
import sys
sys.modules["jax"] = None
sys.modules["control_toolkit_tpu"] = None  # nor the JAX package
import numpy as np, torch
torch.set_num_threads(1)
from control_toolkit_tpu_torch import import_controller_by_name
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
assets = "control_toolkit_tpu_torch/assets/cartpole"
for opt, net in (("mppi", "mlp-64-64"), ("mppi", "GRU-5IN-32H1-32H2-4OUT"),
                 ("rpgd-tf", "mlp-64-64")):
    ctrl = import_controller_by_name(opt)(
        "cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
        {"target_position": 0.0},
        config={"optimizer": opt, "controller_logging": False, "device": "cpu"})
    ctrl.configure(optimizer_name=opt, predictor_specification=f"neural:{net}:{assets}",
                   optimizer_config={"seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 10,
                                     "num_rollouts": 32,
                                     "period_interpolation_inducing_points": 5},
                   cost_function_config={"dd_weight": 120.0, "ep_weight": 10000.0,
                                         "ekp_weight": 10.0, "cc_weight": 1.0,
                                         "ccrc_weight": 1.0, "R": 1.0})
    assert ctrl.optimizer.predictor.predictor.net_params  # the committed net, loaded
    s, _ = CartpoleEnv(batch_size=1, dt=0.02, seed=0).reset()
    for _ in range(3):
        u = ctrl.step(s[0])
    assert np.all(np.isfinite(u)) and u.shape == (1,)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "control_toolkit_tpu"))
assert loaded == ["control_toolkit_tpu", "jax"], loaded  # only the blocked placeholders
print("NO_JAX_OK")
"""


def test_learned_dynamics_path_runs_without_jax_or_the_jax_package():
    res = run_python(["-c", NO_JAX_NEURAL_DRIVE], REPO)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX_OK" in res.stdout


NO_JAX_SAMPLING_DRIVE = r"""
import sys
sys.modules["jax"] = None
sys.modules["control_toolkit_tpu"] = None  # nor the JAX package
import numpy as np, torch
torch.set_num_threads(1)
from control_toolkit_tpu_torch import import_controller_by_name
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
cem = {"cem_outer_it": 2, "cem_best_k": 16}
for opt, extra, fused in (("cem-tf", {**cem, "fully_fused": True}, True),
                          ("cem-tf", cem, False),
                          ("mppi", {"fully_fused": True,
                                    "period_interpolation_inducing_points": 5}, True),
                          ("icem-tf", cem, False), ("random-action-tf", {}, False)):
    ctrl = import_controller_by_name(opt)(
        "cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
        {"target_position": 0.0},
        config={"optimizer": opt, "controller_logging": False, "device": "cpu"})
    ctrl.configure(optimizer_name=opt,
                   optimizer_config={"seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 10,
                                     "num_rollouts": 2048, **extra},
                   cost_function_config={"dd_weight": 120.0, "ep_weight": 10000.0,
                                         "ekp_weight": 10.0, "cc_weight": 1.0,
                                         "ccrc_weight": 1.0, "R": 1.0})
    assert getattr(ctrl.optimizer, "_can_fully_fuse", lambda: False)() == fused, opt
    env = CartpoleEnv(batch_size=1, dt=0.02, seed=0)
    s, _ = env.reset()
    for _ in range(3):
        u = ctrl.step(s[0])
        s, *_ = env.step(u)
    assert np.all(np.isfinite(u)) and u.shape == (1,)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "control_toolkit_tpu"))
assert loaded == ["control_toolkit_tpu", "jax"], loaded  # only the blocked placeholders
print("NO_JAX_OK")
"""


def test_sampling_paths_run_without_jax_or_the_jax_package():
    """cem-tf (fully fused and modular), fully-fused mppi, icem-tf and
    random-action-tf, stepped on the CPU with jax and the JAX package
    blocked."""
    res = run_python(["-c", NO_JAX_SAMPLING_DRIVE], REPO)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX_OK" in res.stdout


def test_explicit_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("tpu")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("spec", [None, "", "default"])
def test_the_default_device_is_the_card_and_raises_without_one(spec):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(spec)


def mpc_without_device():
    """An "mpc" controller whose config names no device, configured."""
    from control_toolkit_tpu_torch import import_controller_by_name

    ctrl = import_controller_by_name("mpc")(
        "cartpole", (np.array([-1.0], np.float32), np.array([1.0], np.float32)),
        {"target_position": 0.0}, config={"optimizer": "mppi", "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", optimizer_config={
        "seed": 0, "mpc_timestep": 0.02, "mpc_horizon": 10, "num_rollouts": 32,
        "period_interpolation_inducing_points": 5},
        cost_function_config=COST_WEIGHTS)
    return ctrl


def test_a_controller_without_a_device_raises_without_a_card():
    """No "device" key means the card: without one the controller raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mpc_without_device()


@pytest.mark.cuda
def test_a_controller_without_a_device_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a controller's default device is the card")
    ctrl = mpc_without_device()
    opt = ctrl.optimizer
    assert ctrl.device == opt.device == torch.device("cuda", 0)
    assert opt.action_low.device == opt.u.device == torch.device("cuda", 0)
    u = ctrl.step(np.array([0.0, 0.0, 0.05, 0.0], np.float32))
    assert np.all(np.isfinite(u)) and u.shape == (1,)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """In the checkout, and alone in an empty directory, the script exits
    non-zero and never prints a result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        res = run_python(["chip_smoke.py"], tmp_path)
    else:
        res = run_python([str(script)], REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
