"""Fused rollout + cost as a Python loop (counterpart of
control_toolkit_tpu/ops/rollout.py).

``scan_cost_rollout`` accumulates the stage cost inside the horizon loop
so only the ``[B]`` cost and the final state leave it: trajectory cost =
(sum_h stage(s_h, u_h, u_{h-1}) + terminal(s_H)) / (H+1), with
u_{-1} = u_prev seeding the control-change penalty.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def scan_cost_rollout(
    step_fn: Callable,          # (x [B,S], u [B,U], params) -> x_next
    stage_cost_fn: Callable,    # (x [B,S], u [B,U], u_prev [B,U], params) -> [B]
    terminal_cost_fn: Callable, # (x [B,S], params) -> [B]
    s0: torch.Tensor,           # [B, S]
    Q: torch.Tensor,            # [B, H, U]
    u_prev,                     # [U] or [B, U]: the actually applied control
    params: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (trajectory_cost [B], final_state [B,S])."""
    B, H, U = Q.shape
    if u_prev is None:
        u_prev_b = torch.zeros((B, U), dtype=Q.dtype, device=Q.device)
    else:
        up = torch.as_tensor(u_prev, dtype=Q.dtype, device=Q.device)
        if up.ndim == 2:
            u_prev_b = up.expand(B, U)
        else:
            if up.numel() not in (1, U):
                # A [B] vector or a flattened plan would silently seed every
                # rollout with its first U values — reject it instead.
                raise ValueError(
                    f"1-D u_prev must have exactly U={U} elements (or be "
                    f"scalar), got shape {tuple(up.shape)}; pass [B, U] for "
                    "per-rollout values"
                )
            u_prev_b = up.reshape(-1).expand(B, U)

    x, up, acc = s0, u_prev_b, torch.zeros(B, dtype=s0.dtype, device=s0.device)
    for h in range(H):
        u = Q[:, h, :]
        acc = acc + stage_cost_fn(x, u, up, params)
        x = step_fn(x, u, params)
        up = u
    total = (acc + terminal_cost_fn(x, params)) / (H + 1)
    return total, x
