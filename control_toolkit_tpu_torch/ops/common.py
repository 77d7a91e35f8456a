"""Shared numerical ops of the gradient optimizers (counterpart of
control_toolkit_tpu/ops/common.py).

``AdamState.step`` is a host Python int, or a numpy int array ``[B]`` of
per-session counters in a batched fleet's stacked state: the bias
correction is computed on the host in float32 (as the JAX package casts
its int32 counter to float32), so an update never reads a device value
back.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def clip_by_norm(t: torch.Tensor, clip_norm: float, axes: Tuple[int, ...]) -> torch.Tensor:
    """Per-slice norm clipping with TF ``clip_by_norm`` semantics:
    ``t * clip_norm / max(||t||, clip_norm)`` over ``axes``."""
    l2 = torch.sqrt(torch.sum(t * t, dim=axes, keepdim=True))
    return t * (clip_norm / torch.clamp_min(l2, clip_norm))


def elite_indices(costs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k lowest costs, best first.  (``lax.top_k`` breaks
    ties by the lower index; ``torch.topk`` on a CUDA tensor may not.)"""
    return torch.topk(costs, k, largest=False, sorted=True).indices


class AdamState(NamedTuple):
    step: int           # host counter (a numpy [B] in a fleet's stacked state)
    m: torch.Tensor
    v: torch.Tensor


def adam_init(shape, device: torch.device, dtype=torch.float32) -> AdamState:
    return AdamState(step=0, m=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def adam_update(state: AdamState, grad: torch.Tensor, lr: float, beta_1: float = 0.9,
                beta_2: float = 0.999, epsilon: float = 1e-8) -> Tuple[AdamState, torch.Tensor]:
    """One Adam step as tf.keras.optimizers.Adam applies it:

        lr_t  = lr * sqrt(1 - b2^t) / (1 - b1^t)
        delta = lr_t * m / (sqrt(v) + eps)

    epsilon goes on the un-corrected sqrt(v), not on sqrt(v_hat).  With
    per-session counters (``step`` a numpy ``[B]``, the moments ``[B,
    ...]``) each session takes its own lr_t, as the JAX package's vmapped
    update does.  Returns (new_state, delta); delta is to be subtracted."""
    step = state.step + 1
    m = beta_1 * state.m + (1.0 - beta_1) * grad
    v = beta_2 * state.v + (1.0 - beta_2) * grad * grad
    t = torch.as_tensor(np.asarray(step, np.float32))  # on the host
    lr_t = lr * torch.sqrt(1.0 - beta_2**t) / (1.0 - beta_1**t)
    if lr_t.ndim:
        lr_t = lr_t.to(m.device).reshape((-1,) + (1,) * (m.ndim - 1))
    delta = lr_t * m / (torch.sqrt(v) + epsilon)
    return AdamState(step=step, m=m, v=v), delta


def adam_descent(Q: torch.Tensor, adam: AdamState, grad, iterations: int, lr: float,
                 beta_1: float, beta_2: float, epsilon: float, clip_norm: float,
                 low: torch.Tensor, high: torch.Tensor) -> Tuple[torch.Tensor, AdamState]:
    """``iterations`` Adam steps on the population ``Q [K,H,U]`` (or a
    fleet's ``[B,K,H,U]``, with per-session counters): each rollout's
    gradient ``grad(Q)`` clipped to norm ``clip_norm`` over its [H, U]
    axes, the controls clamped to ``[low, high]`` after every step."""
    for _ in range(iterations):
        adam, delta = adam_update(adam, clip_by_norm(grad(Q), clip_norm, axes=(-2, -1)), lr,
                                  beta_1, beta_2, epsilon)
        Q = torch.clamp(Q - delta, low, high)
    return Q, adam


def shift_adam_moments(state: AdamState) -> AdamState:
    """Move m and v one step left along the horizon (axis -2 of [K, H, U]
    or a fleet's [B, K, H, U]), zero-padding the tail."""
    return AdamState(step=state.step, m=shift_rows(state.m), v=shift_rows(state.v))


def shift_rows(M: torch.Tensor) -> torch.Tensor:
    """Time-shift rows left along the horizon (axis -2), zero-padding the
    tail."""
    return torch.cat([M[..., 1:, :], torch.zeros_like(M[..., :1, :])], dim=-2)
