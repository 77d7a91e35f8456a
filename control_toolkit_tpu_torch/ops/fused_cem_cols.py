"""K6: fully-fused CEM sampling, rollout and cost of B sessions in one
launch — the counterpart of control_toolkit_tpu/ops/pallas_cem.py:
build_fused_cem_cols (kernel and ``regen_cols``).

``fused_cem_cols(model, s0 [B,S], mue [B,H,U], std [B,H,U], pvec_b [B,N],
seed_b [B] int32, low [U], high [U], K) -> cost [B, K]``.  Session b's
rollout ``k = r*cps + cw`` (``cps = K/8``; the JAX layout's sublane r and
session-local column cw, the order of the JAX step's ``costs [B, K]``)
draws its control at step h and input j as

    u = clamp(mue[b,h,j] + std[b,h,j] * z, low[j], high[j]),
    z = normal(seed_b[b]*FNV + j*H*K + (h*8 + r)*cps + cw)

(uint32 arithmetic, ``ops/counter_prng.py``; not K5's counter, which has a
tile term), and its cost is K1's ``(sum_h stage + terminal) / (H+1)`` with
the session's packed parameters ``pvec_b[b]``.  A session's samples depend
on its own seed and K only, so its results do not depend on B.  ``seed_b``
is read from device memory: seeds drawn on the card never go through the
host.

``regen_cols(seed_b, idx [B,k], mue, std, low, high, K, fast=)`` draws the
clipped controls ``[B, k, H, U]`` of each session's rollouts ``idx[b]``
again from the same counters, for the elite refit, in one set of torch
launches whatever B is: torch glue, as ``regen_cols`` is XLA glue in JAX.
``fast`` (no default) is the kernel's plant's ``fast_math`` (the fast
normals).
``fused_cem_cols_plain`` is the kernel's function in PyTorch: every row
regenerated and scored by K1's plain version.

The CUDA kernel is ``csrc/fused_cem_cols.cu``, over the rollout body it
shares with K5 (``csrc/cem_core.cuh``), with K5's instances (``fast`` as
K5's).  The wrapper runs the plain
version only when every operand lies on the CPU; for CUDA operands it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout_plain
from control_toolkit_tpu_torch.ops.counter_prng import (
    FNV, MASK, ROWS, mul32, normals_from_counter,
)
from control_toolkit_tpu_torch.ops.mppi_cost_cols import per_rollout


def check_k(name: str, K: int) -> None:
    """The counter layout's rollout order ``k = r*(K/8) + cw`` needs K a
    multiple of 8."""
    if K < ROWS or K % ROWS:
        raise ValueError(f"{name}: K={K} must be a positive multiple of {ROWS}")


def cols_counters(seed_b: torch.Tensor, idx: torch.Tensor, K: int, H: int,
                  U: int) -> torch.Tensor:
    """The int64 counters ``[B, k, H, U]`` of each session's rollouts
    ``idx [B, k]``: ``(h*8 + r)*cps + cw = h*K + k`` for ``k = r*cps + cw``."""
    base = mul32(seed_b.to(torch.int64) & MASK, FNV)                       # [B]
    dev = idx.device
    h = torch.arange(H, dtype=torch.int64, device=dev)
    j = torch.arange(U, dtype=torch.int64, device=dev)
    row = base[:, None] + idx.to(torch.int64)                               # [B, k]
    return row[:, :, None, None] + h[:, None] * K + j * (H * K)


def regen_cols(seed_b: torch.Tensor, idx: torch.Tensor, mue: torch.Tensor, std: torch.Tensor,
               low: torch.Tensor, high: torch.Tensor, K: int, *, fast: bool) -> torch.Tensor:
    """The clipped controls ``[B, k, H, U]`` that K6 drew for each
    session's rollouts ``idx [B, k]``; ``fast`` as the kernel's plant."""
    B, H, U = mue.shape
    z = normals_from_counter(cols_counters(seed_b, idx, K, H, U), fast)
    return torch.clamp(mue[:, None] + std[:, None] * z, low, high)


def fused_cem_cols_plain(model: kernels.RolloutModel, s0, mue, std, pvec_b, seed_b, low, high,
                         K: int) -> torch.Tensor:
    """The kernel's function in PyTorch: every row regenerated, then K1's
    plain rollout with each session's parameters per rollout."""
    B, H, U = mue.shape
    idx = torch.arange(K, device=mue.device).expand(B, K)
    Q = regen_cols(seed_b, idx, mue, std, low, high, K, fast=model.fast_math).reshape(B * K, H, U)
    cost = cost_rollout_plain(model, per_rollout(s0, K).T, Q, per_rollout(pvec_b, K))
    return cost.reshape(B, K)


def fused_cem_cols(model: kernels.RolloutModel, s0: torch.Tensor, mue: torch.Tensor,
                   std: torch.Tensor, pvec_b: torch.Tensor, seed_b: torch.Tensor,
                   low: torch.Tensor, high: torch.Tensor, K: int) -> torch.Tensor:
    """Per-session, per-rollout CEM cost ``[B, K]``; see the module
    docstring."""
    if (s0.ndim != 2 or mue.ndim != 3 or std.shape != mue.shape or pvec_b.ndim != 2
            or mue.shape[0] != s0.shape[0] or pvec_b.shape[0] != s0.shape[0]
            or low.shape != (mue.shape[2],) or high.shape != low.shape):
        raise ValueError(
            "fused_cem_cols: expected s0 [B,S], mue/std [B,H,U], pvec_b [B,N], low/high [U]; "
            f"got {tuple(s0.shape)}, {tuple(mue.shape)}, {tuple(std.shape)}, "
            f"{tuple(pvec_b.shape)}, {tuple(low.shape)}, {tuple(high.shape)}")
    check_k("fused_cem_cols", K)
    B = s0.shape[0]
    if seed_b.shape != (B,) or seed_b.dtype != torch.int32:
        raise ValueError(f"fused_cem_cols: seed_b must be an int32 [{B}] tensor, got "
                         f"{seed_b.dtype} {tuple(seed_b.shape)}")
    if kernels.on_cpu(s0, mue, std, pvec_b, seed_b, low, high):
        return fused_cem_cols_plain(model, s0, mue, std, pvec_b, seed_b, low, high, K)
    kernels.require("K6", model.plant)
    device = kernels.check_cuda_operands("fused_cem_cols", s0=s0, mue=mue, std=std,
                                         pvec_b=pvec_b, low=low, high=high)
    if seed_b.device != device or not seed_b.is_contiguous():
        raise ValueError(f"fused_cem_cols: seed_b must be contiguous on {device}, got "
                         f"{seed_b.device}")
    H, U = mue.shape[1], mue.shape[2]
    model.check_launch_shape("fused_cem_cols", s0.shape[1], U, B * K, H, pvec_b.shape[1])
    cost = torch.empty(B, K, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_fused_cem_cols(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), mue.data_ptr(), std.data_ptr(),
            pvec_b.data_ptr(), seed_b.data_ptr(), low.data_ptr(), high.data_ptr(),
            cost.data_ptr(), B, K, H, *model.step_args(), model.max_cost, int(model.fast_math),
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, "fused_cem_cols")
    fused_cem_cols.launches += 1
    return cost


fused_cem_cols.launches = 0
