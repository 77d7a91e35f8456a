"""Circular-obstacle penalty for planar navigation costs (counterpart of
control_toolkit_tpu/costs/obstacles.py).

Each of ``N_OBSTACLES`` obstacles is three scalar attributes
(``obs<i>_x``, ``obs<i>_y``, ``obs<i>_r``), so obstacles move at run time
as targets do and a cost using them keeps the kernel paths (its
attributes ride the packed parameter vector).  Penalty: the smooth hinge
``obstacle_weight * max(0, 1 - d^2 / r_margin^2)^2`` per obstacle, with
``r_margin = r + clearance``; an inactive obstacle has r = 0 and sits far
away (the defaults).
"""
from __future__ import annotations

import torch

N_OBSTACLES = 3

OBSTACLE_ATTR_KEYS = tuple(
    f"obs{i}_{c}" for i in range(N_OBSTACLES) for c in ("x", "y", "r")
)
OBSTACLE_ATTR_DEFAULTS = {}
for _i in range(N_OBSTACLES):
    OBSTACLE_ATTR_DEFAULTS.update({f"obs{_i}_x": 1e6, f"obs{_i}_y": 1e6, f"obs{_i}_r": 0.0})
del _i

OBSTACLE_CONFIG_KEYS = ("obstacle_weight", "clearance")
OBSTACLE_CONFIG_DEFAULTS = {"obstacle_weight": 200.0, "clearance": 0.15}


def obstacle_penalty(x, y, params):
    """The summed smooth-hinge penalty over all obstacles at (x, y); the
    hinge is torch.maximum, whose gradient splits at a tie as
    jnp.maximum's does."""
    w = params["cost"]
    attrs = params["attrs"]
    pen = 0.0
    for i in range(N_OBSTACLES):
        ox = attrs.get(f"obs{i}_x", 1e6)
        oy = attrs.get(f"obs{i}_y", 1e6)
        orr = attrs.get(f"obs{i}_r", 0.0)
        margin = orr + w["clearance"]
        d2 = (x - ox) ** 2 + (y - oy) ** 2
        v = 1.0 - d2 / (margin * margin)
        h = torch.maximum(torch.zeros_like(v), v)
        pen = pen + h * h
    return w["obstacle_weight"] * pen
