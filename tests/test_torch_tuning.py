"""``evaluation/tuning.py`` (``grid_search``) and the sweep overlay against
the JAX package on the CPU.

``_nest``, ``_combos`` and ``_overlay_sweep`` are held to JAX's functions on
the same numpy inputs (the same trees, axes, paths and errors);
``_rescore_fixed`` to JAX's on the same trajectories under the same cost
(float32 sums: rtol 1e-6); ``grid_search`` to JAX's over a stub loop
whose sweep results are a fixed function of the overlay, so that both
packages see the same episodes: the cross product in ``itertools.product``
order, the per-config means, the ranking, the best config and cost, the
``fixed`` scores and the ``static_grid`` merge.  On a real port loop the
``swept`` score is the mean of the sweep's costs per config, a static
combination's sub-table equals a standalone search, and the inputs are
validated as JAX validates them.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from control_toolkit_tpu.controllers.mpc import MPCController as JaxMPC
from control_toolkit_tpu.evaluation import closed_loop as jax_closed_loop
from control_toolkit_tpu.evaluation import grid_search as jax_grid_search
from control_toolkit_tpu.evaluation import tuning as jax_tuning
from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.evaluation import ClosedLoop, closed_loop, grid_search, tuning
from control_toolkit_tpu_torch.utils.rng import make_generator

LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
S0 = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
MPPI = {"seed": 5, "mpc_timestep": 0.02, "mpc_horizon": 8, "num_rollouts": 32,
        "SQRTRHOINV": 0.05, "period_interpolation_inducing_points": 4, "cc_weight": 1.0,
        "R": 1.0, "LBD": 100.0, "NU": 1000.0}
GRID = {"cost.dd_weight": np.array([10.0, 120.0, 400.0], np.float32),
        "attrs.target_position": np.array([0.0, 0.3], np.float32)}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def leaves_numpy(tree):
    if isinstance(tree, dict):
        return {k: leaves_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_nest_and_combos_match_jax():
    flat = {"cost.dd_weight": np.arange(3.0), "attrs.target_position": np.ones(3),
            "dyn.base.L": np.zeros(3)}
    mine, theirs = tuning._nest(flat), jax_tuning._nest(flat)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(a, b)
    for bad in ({"a.b": 1, "a.b.c": 2}, {"a.b": 1, "a": {"b": 2}}):
        for nest in (tuning._nest, jax_tuning._nest):
            with pytest.raises(ValueError):
                nest(bad)
    p, v, c = tuning._combos(GRID)
    jp, jv, jc = jax_tuning._combos(GRID)
    assert p == jp and c == jc == list(itertools.product(range(3), range(2)))
    for a, b in zip(v, jv):
        np.testing.assert_array_equal(a, b)
    for bad in ({"x": np.array(1.0)}, {"x": np.zeros(0)}):
        for combos in (tuning._combos, jax_tuning._combos):
            with pytest.raises(ValueError, match="non-empty"):
                combos(bad)


def test_overlay_sweep_matches_jax():
    """The merged tree (leaves as numpy), the axes tree and the sorted swept
    paths, and the same errors."""
    params = {"dyn": {"L": np.float32(0.5), "base": {"m": np.float32(1.0)},
                      "net": {"w": np.ones((2, 3), np.float32)}},
              "cost": {"dd_weight": np.float32(120.0), "R": np.float32(1.0)},
              "attrs": {"target_position": np.float32(0.0)}}
    sweep = {"dyn": {"L": np.arange(4.0), "net": {"w": np.ones((4, 2, 3))}},
             "cost": {"R": np.linspace(0.0, 1.0, 4)}}
    merged, axes, paths = closed_loop._overlay_sweep(params, sweep, 4)
    jmerged, jaxes, jpaths = jax_closed_loop._overlay_sweep(params, sweep, 4)
    assert paths == jpaths == ["cost.R", "dyn.L", "dyn.net.w"]
    assert axes == jaxes
    mine, theirs = leaves_numpy(merged), leaves_numpy(jmerged)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for bad, err in (({"cost": {"R": np.zeros(3)}}, ValueError),
                     ({"cost": {"nope": np.zeros(4)}}, KeyError),
                     ({"cost": {"R": {"x": np.zeros(4)}}}, KeyError)):
        for overlay in (closed_loop._overlay_sweep, jax_closed_loop._overlay_sweep):
            with pytest.raises(err):
                overlay(params, bad, 4)


def controllers():
    jctrl = JaxMPC("cartpole", LIMITS, {"target_position": 0.1},
                   config={"optimizer": "mppi", "controller_logging": False})
    jctrl.configure(optimizer_name="mppi", optimizer_config=dict(MPPI))
    pctrl = MPCController("cartpole", LIMITS, {"target_position": 0.1},
                          config={"optimizer": "mppi", "device": "cpu",
                                  "controller_logging": False})
    pctrl.configure(optimizer_name="mppi", optimizer_config=dict(MPPI))
    return jctrl, pctrl


class StubLoop:
    """A loop whose sweep is a fixed function of its overlay and N: the
    same episodes for both packages' grid_search."""

    def __init__(self, controller, offset=0.0):
        self.controller, self.offset = controller, offset

    def run_batch(self, s0_batch, ticks, sweep_params=None, mesh=None,
                  return_trajectories=False):
        N = s0_batch.shape[0]
        rng = np.random.default_rng(N + ticks)
        swept = np.zeros(N)
        for leaf in jax.tree_util.tree_leaves(sweep_params or {}):
            swept = swept + np.asarray(leaf, np.float64).reshape(N, -1).sum(axis=1)
        stage = (np.cos(swept)[:, None] + self.offset
                 + rng.uniform(0.0, 0.5, (N, ticks))).astype(np.float32)
        out = {"mean_costs": stage.mean(axis=1), "stage_costs": stage,
               "final_states": np.zeros((N, 4), np.float32)}
        if return_trajectories:
            out["states"] = rng.uniform(-0.3, 0.3, (N, ticks, 4)).astype(np.float32)
            out["controls"] = rng.uniform(-1.0, 1.0, (N, ticks, 1)).astype(np.float32)
        return out


@pytest.mark.parametrize("score", ["swept", "fixed"])
def test_grid_search_matches_jax_over_the_same_episodes(score):
    jctrl, pctrl = controllers()
    mine = grid_search(StubLoop(pctrl), GRID, S0, 5, episodes_per_config=2, score=score)
    theirs = jax_grid_search(StubLoop(jctrl), GRID, S0, 5, episodes_per_config=2, score=score)
    assert len(mine["configs"]) == 6
    assert [{k: float(v) for k, v in c.items()} for c in mine["configs"]] == \
           [{k: float(v) for k, v in c.items()} for c in theirs["configs"]]
    tol = dict(rtol=1e-6, atol=0) if score == "fixed" else dict(rtol=0, atol=0)
    np.testing.assert_allclose(mine["mean_costs"], theirs["mean_costs"], **tol)
    np.testing.assert_array_equal(mine["ranking"], theirs["ranking"])
    assert mine["best"] == theirs["best"]
    np.testing.assert_allclose(mine["best_cost"], theirs["best_cost"], **tol)


def test_rescore_fixed_matches_jax():
    jctrl, pctrl = controllers()
    rng = np.random.default_rng(3)
    ss = rng.uniform(-0.3, 0.3, (5, 6, 4)).astype(np.float32)
    us = rng.uniform(-1.0, 1.0, (5, 6, 1)).astype(np.float32)
    got = tuning._rescore_fixed(StubLoop(pctrl), ss, us)
    ref = jax_tuning._rescore_fixed(StubLoop(jctrl), ss, us)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_static_grid_matches_jax_and_validation():
    """A static grid crossed with the swept one (configs merged, static keys
    first), a static-only search, and the input errors JAX raises."""
    jctrl, pctrl = controllers()
    static = {"LBD": np.array([10.0, 100.0], np.float32)}
    sub = {"attrs.target_position": np.array([0.0, 0.4], np.float32)}

    def stub_loops(ctrl):
        return lambda overrides: StubLoop(ctrl, offset=float(overrides["LBD"]) / 100.0)

    for grid in (sub, {}):
        mine = grid_search(None, grid, S0, 4, episodes_per_config=2, static_grid=static,
                           build_loop=stub_loops(pctrl))
        theirs = jax_grid_search(None, grid, S0, 4, episodes_per_config=2, static_grid=static,
                                 build_loop=stub_loops(jctrl))
        assert [{k: float(v) for k, v in c.items()} for c in mine["configs"]] == \
               [{k: float(v) for k, v in c.items()} for c in theirs["configs"]]
        np.testing.assert_array_equal(mine["mean_costs"], theirs["mean_costs"])
        assert mine["best"] == theirs["best"]
    cases = (
        dict(grid={}, args=()),
        dict(grid={"dyn.L": np.array([0.5])}, score="x"),
        dict(grid={"dyn.L": np.array(0.5)}),
        dict(grid={}, static_grid={"LBD": np.array([1.0])}),
        dict(grid={"dyn.L": np.array([0.5])}, build_loop=stub_loops(pctrl)),
    )
    for case in cases:
        kw = {k: v for k, v in case.items() if k not in ("grid", "args")}
        errors = []
        for search, ctrl in ((grid_search, pctrl), (jax_grid_search, jctrl)):
            with pytest.raises(ValueError) as err:
                search(StubLoop(ctrl), case["grid"], S0, 4, **kw)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


def make_loop(**extra):
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "mppi", "device": "cpu",
                                 "controller_logging": False})
    ctrl.configure(optimizer_name="mppi", optimizer_config=dict(MPPI, **extra),
                   cost_function_config=COST_WEIGHTS)
    return ClosedLoop(ctrl, CartpoleEnv(batch_size=1, dt=0.02, seed=0), actuator_noise=0.05)


def test_grid_search_on_a_port_loop():
    """The swept score is the mean of the sweep's per-episode costs by
    config (one K4 sweep of C x E episodes); the fixed score re-scores the
    same trajectories under the base cost; a static combination's
    sub-table equals a standalone search on a loop built with it, bit for
    bit."""
    loop = make_loop()
    grid = {"cost.dd_weight": np.array([10.0, 120.0], np.float32),
            "attrs.target_position": np.array([0.0, 0.3], np.float32)}
    loop._noise_gen = make_generator(7, loop.device)
    res = grid_search(loop, grid, S0, 4, episodes_per_config=2)
    loop._noise_gen = make_generator(7, loop.device)
    sweep = {"cost": {"dd_weight": np.repeat(np.array([10.0, 10.0, 120.0, 120.0],
                                                      np.float32), 2)},
             "attrs": {"target_position": np.repeat(np.array([0.0, 0.3, 0.0, 0.3],
                                                             np.float32), 2)}}
    out = loop.run_batch(np.tile(S0, (8, 1)), 4, sweep_params=sweep, return_trajectories=True)
    np.testing.assert_array_equal(res["mean_costs"], out["mean_costs"].reshape(4, 2).mean(1))
    assert res["best"] == res["configs"][int(np.argmin(res["mean_costs"]))]
    loop._noise_gen = make_generator(7, loop.device)
    fixed = grid_search(loop, grid, S0, 4, episodes_per_config=2, score="fixed")
    np.testing.assert_array_equal(
        fixed["mean_costs"],
        tuning._rescore_fixed(loop, out["states"], out["controls"]).reshape(4, 2).mean(1))

    def build(overrides):
        built = make_loop(**{k: float(v) for k, v in overrides.items()})
        built._noise_gen = make_generator(7, built.device)
        return built

    sub = {"attrs.target_position": np.array([0.0, 0.4], np.float32)}
    res = grid_search(None, sub, S0, 4, episodes_per_config=2,
                      static_grid={"LBD": np.array([10.0, 100.0], np.float32)}, build_loop=build)
    assert [c["LBD"] for c in res["configs"]] == [10.0, 10.0, 100.0, 100.0]
    alone = grid_search(build({"LBD": 10.0}), sub, S0, 4, episodes_per_config=2)
    np.testing.assert_array_equal(res["mean_costs"][:2], alone["mean_costs"])
