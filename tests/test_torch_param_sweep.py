"""``ClosedLoop.run_batch`` parameter sweeps on the CPU (the counterpart of
tests/test_param_sweep.py).

Swept row n equals an unswept sweep whose controller holds config n's
value, bit for bit (the same episode generator ``slot_seed(seed, n)`` and
the same actuator noise): an attribute, a dynamics constant and a cost
weight on the MPPI kernel sweep (K4's rows), a cost weight on the rpgd-tf
sweep (K7-/K1-cols rows), the residual base's ``dyn.base.L`` on K12's rows,
each sweep's kernel step built with those rows; a vector leaf (an MLP's
bias) takes the per-episode path, row n equal to ``run`` of episode n with
that bias.  A constant sweep equals the unswept sweep; a mismatched
dynamics constant changes the plan; the overlay's validation errors.
"""
import numpy as np
import pytest
import torch

from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.evaluation import ClosedLoop
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.utils.rng import make_generator, slot_seed

LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
ASSETS = kernels.PACKAGE_DIR / "assets" / "cartpole"
S0 = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
N, T = 4, 4
MPPI = {"seed": 5, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 32,
        "SQRTRHOINV": 0.05, "period_interpolation_inducing_points": 4}
RPGD = {"seed": 5, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 32, "outer_its": 2,
        "warmup": False, "period_interpolation_inducing_points": 4}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_loop(optimizer="mppi", spec="ODE", weights=None, **extra):
    cfg = dict(MPPI if optimizer == "mppi" else RPGD, **extra)
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "device": "cpu",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config=cfg, cost_function_config=dict(COST_WEIGHTS, **(weights or {})))
    return ClosedLoop(ctrl, CartpoleEnv(batch_size=1, dt=0.02, seed=0), actuator_noise=0.05)


def rewound(loop):
    """The loop's actuator noise from its seed again."""
    loop._noise_gen = make_generator(7, loop.device)
    return loop


def set_value(loop, path: str, value: float) -> None:
    """The controller's own value of a dotted params path."""
    top, _, leaf = path.partition(".")
    ctrl = loop.controller
    if top == "attrs":
        ctrl.update_attributes({leaf: value})
    elif top == "dyn":
        pred = ctrl.predictor.predictor
        if leaf.startswith("base."):
            pred.base._defaults[leaf[len("base."):]] = value
        else:
            pred._defaults[leaf] = value
    else:
        raise ValueError(path)


SWEEPS = {  # case: (optimizer, spec, dotted path, values, kernel kind, rows)
    "attrs": ("mppi", "ODE", "attrs.target_position", [0.0, 0.4, -0.3, 0.2], "ode", ((), ())),
    "dyn": ("mppi", "ODE", "dyn.L", [0.5, 0.7, 0.35, 0.6], "ode", (("L",), ())),
    "cost": ("mppi", "ODE", "cost.dd_weight", [120.0, 10.0, 500.0, 60.0], "ode",
             ((), ("dd_weight",))),
    "rpgd_cost": ("rpgd-tf", "ODE", "cost.ep_weight", [10000.0, 100.0, 3000.0, 500.0], "rpgd",
                  ((), ("ep_weight",))),
    "residual_base": ("mppi", "ODE+res", "dyn.base.L", [0.5, 0.8, 0.3, 0.6], "residual",
                      (("L",), ())),
}


def overlay(path: str, values) -> dict:
    *parents, leaf = path.split(".")
    tree = {leaf: np.asarray(values, np.float32)}
    for p in reversed(parents):
        tree = {p: tree}
    return tree


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_swept_rows_equal_unswept_runs_with_their_params(case):
    """Row n of the sweep against row n of an unswept sweep whose controller
    holds value n, bit for bit, on the kernel step built with the swept rows."""
    optimizer, spec, path, values, kind, rows = SWEEPS[case]
    loop = make_loop(optimizer, spec)
    s0s = np.tile(S0, (N, 1))
    swept = rewound(loop).run_batch(s0s, T, sweep_params=overlay(path, values),
                                    return_trajectories=True)
    assert (kind, N, *rows) in loop._kernel_steps
    for n, v in enumerate(values):
        if path.startswith("cost."):
            ref_loop = make_loop(optimizer, spec, weights={path.split(".")[1]: v})
        else:
            ref_loop = make_loop(optimizer, spec)
            set_value(ref_loop, path, v)
        ref = rewound(ref_loop).run_batch(s0s, T, return_trajectories=True)
        np.testing.assert_array_equal(swept["controls"][n], ref["controls"][n])
        np.testing.assert_array_equal(swept["stage_costs"][n], ref["stage_costs"][n])
    assert not np.array_equal(swept["controls"][0], swept["controls"][1])


def test_a_vector_leaf_takes_the_per_episode_path():
    """Sweeping an MLP's first bias ([N, 64]) over rpgd-tf (the rpgd sweep
    carries scalar rows alone): each episode runs its own single-session step
    with its row, equal bit for bit to ``run`` of that episode with the
    controller holding that bias."""
    loop = make_loop("rpgd-tf", f"neural:mlp-64-64:{ASSETS}")
    ctrl, opt = loop.controller, loop.controller.optimizer
    b0 = ctrl._assemble_params()["dyn"]["net"]["b0"].numpy()
    rows = b0[None] + 0.05 * np.arange(N, dtype=np.float32)[:, None]
    s0s = np.tile(S0, (N, 1))
    out = rewound(loop).run_batch(s0s, 2, sweep_params={"dyn": {"net": {"b0": rows}}},
                                  return_trajectories=True)
    assert not loop._kernel_steps  # no kernel step was built
    pred = opt.predictor.predictor
    base_net = pred.net_params
    noise = rewound(loop)._noise((N, 2))
    for n in range(N):
        pred.net_params = dict(base_net, b0=torch.as_tensor(rows[n]))
        state = opt._init_state(make_generator(slot_seed(opt._seed, n), loop.device))
        _, sT, ss, us, stage, _ = loop._episode(state, torch.as_tensor(S0),
                                                ctrl._assemble_params(), noise[n], 2)
        np.testing.assert_array_equal(out["controls"][n], us.numpy())
        np.testing.assert_array_equal(out["stage_costs"][n], stage.numpy())
    assert not np.array_equal(out["controls"][0], out["controls"][N - 1])


def test_constant_sweep_equals_the_unswept_sweep_and_dyn_changes_the_plan():
    """Rows all the base value: the unswept sweep, bit for bit; a mismatched
    pole length changes the plan against the same plant, the true one does
    not."""
    loop = make_loop()
    s0s = np.tile(S0, (N, 1))
    base = rewound(loop).run_batch(s0s, T, return_trajectories=True)
    const = rewound(loop).run_batch(s0s, T, return_trajectories=True, sweep_params={
        "attrs": {"target_position": np.zeros(N, np.float32)}})
    np.testing.assert_array_equal(const["controls"], base["controls"])
    L = np.array([0.5, 1.5, 0.5, 0.5], np.float32)
    out = rewound(loop).run_batch(s0s, T, sweep_params={"dyn": {"L": L}},
                                  return_trajectories=True)
    np.testing.assert_array_equal(out["controls"][0], base["controls"][0])
    assert not np.allclose(out["controls"][1], base["controls"][1], atol=1e-4)


def test_sweep_validation_errors():
    loop = make_loop()
    s0s = np.tile(S0, (3, 1))
    with pytest.raises(ValueError, match="sweep leaf 'attrs.target_position'"):
        loop.run_batch(s0s, 2, sweep_params={"attrs": {"target_position": np.zeros(2)}})
    with pytest.raises(KeyError, match="no_such_key"):
        loop.run_batch(s0s, 2, sweep_params={"attrs": {"no_such_key": np.zeros(3)}})
    with pytest.raises(ValueError, match="no leaves"):
        loop.run_batch(s0s, 2, sweep_params={"attrs": {}})
    with pytest.raises(KeyError, match="non-dict"):
        loop.run_batch(s0s, 2, sweep_params={"dyn": {"L": {"x": np.zeros(3)}}})


def test_swept_kernel_classification():
    """Which leaves ride the kernel step's rows (``_swept_rows``): scalar
    attributes, dynamics constants (``dyn.base.<k>`` of a residual model
    only) and cost weights; a nested or vector leaf, an unknown attribute, a
    non-dynamic cost key: the per-episode path (None)."""
    from control_toolkit_tpu_torch.evaluation.closed_loop import _overlay_sweep

    loop = make_loop()
    params = loop.controller._assemble_params()

    def rows(sweep):
        merged, _, paths = _overlay_sweep(params, sweep, 4)
        return loop._swept_rows(paths, merged)

    z = np.zeros(4, np.float32)
    assert rows({"attrs": {"target_position": z}, "dyn": {"L": z},
                 "cost": {"dd_weight": z}}) == (("L",), ("dd_weight",))
    loop.controller.update_attributes({"vec": np.zeros(2, np.float32)})
    params = loop.controller._assemble_params()
    assert rows({"attrs": {"vec": np.zeros((4, 2), np.float32)}}) is None
    res = make_loop(spec="ODE+res")
    merged, _, paths = _overlay_sweep(res.controller._assemble_params(),
                                      {"dyn": {"base": {"L": z}}}, 4)
    assert paths == ["dyn.base.L"] and res._swept_rows(paths, merged) == (("L",), ())
