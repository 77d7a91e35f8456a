"""Hyperparameter grid search over closed-loop episodes (counterpart of
control_toolkit_tpu/evaluation/tuning.py).

Every candidate configuration is more episodes of one
``ClosedLoop.run_batch`` parameter sweep, ranked by realized closed-loop
cost.  Two parameter kinds:

- **Swept** (``grid``): values the step reads from its params, cost
  weights, environment attributes, dynamics constants; the whole grid is
  the episodes of one sweep, nothing rebuilt.
- **Static** (``static_grid`` + ``build_loop``): values the step is built
  with, optimizer hyperparameters (LBD, the sampling spread, K, H); each
  combination rebuilds the controller, the swept grid riding inside it.

Two scorings, because sweeping cost parameters changes the metric itself:
``score='swept'`` ranks by the stage costs each episode computed under its
own parameters (robustness studies); ``score='fixed'`` re-scores every
trajectory under the controller's base cost parameters (tuning weights by
one common yardstick).
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    """{'cost.cost_weight': v, ...} -> nested overlay dict."""
    out: Dict = {}
    for dotted, v in flat.items():
        node = out
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"grid path '{dotted}' conflicts with a shorter path")
        if leaf in node:
            raise ValueError(f"duplicate grid path '{dotted}'")
        node[leaf] = v
    return out


def _combos(grid: Dict[str, np.ndarray]):
    """(paths, value arrays, index combos in itertools.product order)."""
    paths = list(grid)
    values: List[np.ndarray] = [np.asarray(grid[p]) for p in paths]
    for p, v in zip(paths, values):
        if v.ndim == 0 or v.shape[0] == 0:
            raise ValueError(f"grid['{p}'] must be a non-empty value array")
    combos = list(itertools.product(*[range(len(v)) for v in values]))
    return paths, values, combos


def _swept_eval(loop, grid, s0, ticks, E, score, mesh):
    """One sweep over the swept cross product: (config dicts, per-config
    mean costs)."""
    if grid:
        paths, values, combos = _combos(grid)
        C = len(combos)
        N = C * E
        sweep_flat = {}
        for j, p in enumerate(paths):
            rows = values[j][np.asarray([c[j] for c in combos])]  # [C, ...]
            sweep_flat[p] = np.repeat(rows, E, axis=0)            # [N, ...]
        sweep = _nest(sweep_flat)
        configs = [{p: values[j][c[j]] for j, p in enumerate(paths)} for c in combos]
    else:
        C, N, sweep = 1, E, None
        configs = [{}]
    s0_batch = np.tile(np.reshape(np.asarray(s0, np.float32), (1, -1)), (N, 1))
    out = loop.run_batch(s0_batch, ticks, sweep_params=sweep, mesh=mesh,
                         return_trajectories=(score == "fixed"))
    if score == "fixed":
        costs = _rescore_fixed(loop, out["states"], out["controls"])
    else:
        costs = out["mean_costs"]
    return configs, np.asarray(costs).reshape(C, E).mean(axis=1)


def grid_search(
    loop,
    grid: Dict[str, np.ndarray],
    s0: np.ndarray,
    ticks: int,
    episodes_per_config: int = 1,
    score: str = "swept",
    mesh=None,
    static_grid: Optional[Dict[str, np.ndarray]] = None,
    build_loop: Optional[Callable[[Dict], object]] = None,
) -> Dict:
    """Evaluate the cross product of ``grid`` (x ``static_grid``).

    ``loop`` is a configured ``ClosedLoop``; ``grid`` maps dotted params
    paths ('cost.<weight>', 'attrs.<target>', 'dyn.<constant>') to 1-D
    value arrays (or ``[n_values, *leaf_shape]`` for vector leaves).  Every
    config runs ``episodes_per_config`` episodes from ``s0`` on their own
    streams (optimizer draws and actuator noise), and configs are ranked by
    the mean realized closed-loop cost.

    ``static_grid`` maps free-form names (optimizer-config keys such as
    'LBD') to value arrays; each static combination is evaluated on a fresh
    ``build_loop(overrides)``-built ClosedLoop, with the swept ``grid``
    riding inside it.  ``grid`` may be empty ({}) with a ``static_grid``,
    and ``loop`` None.  ``mesh`` is not ported (``run_batch`` raises).

    Returns {'configs': list[dict] in grid order (static keys merged in),
    'mean_costs': [C], 'ranking': [C] indices best-first, 'best': dict,
    'best_cost': float}.
    """
    if score not in ("swept", "fixed"):
        raise ValueError(f"score must be 'swept' or 'fixed', got {score!r}")
    E = int(episodes_per_config)

    if static_grid:
        if build_loop is None:
            raise ValueError("static_grid requires build_loop(overrides)")
        s_paths, s_values, s_combos = _combos(static_grid)
        configs, costs = [], []
        for c in s_combos:
            overrides = {p: s_values[j][c[j]] for j, p in enumerate(s_paths)}
            sub_loop = build_loop(dict(overrides))
            sub_cfgs, sub_costs = _swept_eval(sub_loop, grid, s0, ticks, E, score, mesh)
            configs += [{**overrides, **sc} for sc in sub_cfgs]
            costs.append(sub_costs)
        per_cfg = np.concatenate(costs)
    else:
        if not grid:
            raise ValueError("grid is empty")
        if build_loop is not None:
            raise ValueError("build_loop is only meaningful with static_grid")
        configs, per_cfg = _swept_eval(loop, grid, s0, ticks, E, score, mesh)

    ranking = np.argsort(per_cfg, kind="stable")
    best = int(ranking[0])
    return {
        "configs": configs,
        "mean_costs": per_cfg,
        "ranking": ranking,
        "best": configs[best],
        "best_cost": float(per_cfg[best]),
    }


def _rescore_fixed(loop, states: np.ndarray, controls: np.ndarray) -> np.ndarray:
    """Mean realized stage cost of ``[N,T,S]`` / ``[N,T,U]`` trajectories
    under one fixed set of cost params (the controller's current assembled
    params), on the controller's device: the common yardstick for
    cost-weight tuning."""
    cf = loop.controller.cost_function.cost_function
    params = loop.controller._assemble_params()
    p = {"cost": params["cost"], "attrs": params["attrs"]}
    device = loop.controller.device
    ss = torch.as_tensor(np.asarray(states, np.float32), device=device)
    us = torch.as_tensor(np.asarray(controls, np.float32), device=device)
    N, T, U = us.shape
    u_prev = torch.cat([torch.zeros((N, 1, U), dtype=us.dtype, device=device), us[:, :-1]], dim=1)
    flat = cf.stage_cost_step(ss.reshape(N * T, -1), us.reshape(N * T, U),
                              u_prev.reshape(N * T, U), p)
    return torch.mean(flat.reshape(N, T), dim=1).cpu().numpy()
