"""K5: fully-fused CEM sampling, rollout and cost — the counterpart of
control_toolkit_tpu/ops/pallas_cem.py:build_fused_cem (single-session form).

``fused_cem_costs(model, s0 [S], mue [H,U], std [H,U], pvec [N], seed2 [2]
int32, low [U], high [U], K, tile_k) -> cost [K]``.  Rollout g, in the JAX
kernel's ``costs2d.reshape(-1)`` order, is (sublane r, tile t, lane c) of a
tile of ``ROWS x C`` rollouts, ``C = tile_k/ROWS``:
``r = g // (K/ROWS)``, ``t = (g % (K/ROWS)) // C``, ``c = g % C``.  Its
control at step h and input j is

    u = clamp(mue[h,j] + std[h,j] * z, low[j], high[j]),
    z = normal(seed*FNV + (off+t)*H*tile_k*U + j*H*tile_k + (h*ROWS + r)*C + c)

(``seed2 = [seed, off]``, uint32 arithmetic, ``ops/counter_prng.py``), and
the cost is K1's: ``(sum_h stage + terminal) / (H+1)``, with no correction
term.  ``tile_k`` is part of the function, not a launch shape: it fixes
which counter each rollout reads, so ``K % tile_k`` must be 0, as JAX's
``build_fused_cem`` asserts.  ``seed2`` is read from device memory, so a seed drawn on
the card never goes through the host.

``regen_controls(seed2, flat_idx, mue, std, low, high, K, tile_k, fast=)``
draws the clipped controls of the rollouts ``flat_idx`` again from the
same counters (the CEM refit needs only the elite rows): torch glue, as it
is XLA glue in JAX (pallas_cem.py:145-163), not a kernel's plain version.
Over a fast plant (``model.fast_math``) the kernel draws the fast normals
(the JAX ``fast_sampling`` form), and ``fast``, which has no default, must
say so.
``fused_cem_costs_plain`` is the kernel's function in PyTorch: all K rows
regenerated and scored by K1's plain version.

The CUDA kernel is ``csrc/fused_cem.cu``, over the rollout body it shares
with K6 (``csrc/cem_core.cuh``, whose note says what bounds it on the
card), with an instance of every device plant; the wrapper passes
``model.fast_math``, which picks the point mass's fast-normals instance
(its exact dynamics under the fast normals, ``RolloutModel.fast_sampling``).  The wrapper runs the plain version only when
every operand lies on the CPU; for CUDA operands it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout_plain
from control_toolkit_tpu_torch.ops.counter_prng import (
    DEFAULT_TILE_K, ROWS, normals_from_counter, rollout_coords, seed_base,
)


def check_tiling(name: str, K: int, tile_k: int) -> None:
    """The counter layout's tiling: ``tile_k`` a multiple of ROWS that
    divides K (pallas_cem.py:67, :83)."""
    if tile_k < ROWS or tile_k % ROWS or K < tile_k or K % tile_k:
        raise ValueError(f"{name}: K={K} must be a multiple of tile_k={tile_k}, "
                         f"itself a multiple of {ROWS}")


def check_seed2(name: str, seed2: torch.Tensor, device: torch.device) -> None:
    if seed2.shape != (2,) or seed2.dtype != torch.int32 or seed2.device != device:
        raise ValueError(f"{name}: seed2 must be an int32 [2] tensor on {device}, got "
                         f"{seed2.dtype} {tuple(seed2.shape)} on {seed2.device}")


def cem_counters(seed2: torch.Tensor, flat_idx: torch.Tensor, K: int, H: int, U: int,
                 tile_k: int) -> torch.Tensor:
    """The int64 counters ``[k, H, U]`` of the rollouts ``flat_idx``."""
    C = tile_k // ROWS
    stride = H * tile_k  # counters per (tile, input)
    base, off = seed_base(seed2)
    r, t, c = rollout_coords(flat_idx.to(torch.int64), K, tile_k)
    dev = flat_idx.device
    h = torch.arange(H, dtype=torch.int64, device=dev)
    j = torch.arange(U, dtype=torch.int64, device=dev)
    row = base + (off + t) * (stride * U) + r * C + c                     # [k]
    return row[:, None, None] + h[None, :, None] * tile_k + j[None, None, :] * stride


def regen_controls(seed2: torch.Tensor, flat_idx: torch.Tensor, mue: torch.Tensor,
                   std: torch.Tensor, low: torch.Tensor, high: torch.Tensor, K: int,
                   tile_k: int = DEFAULT_TILE_K, *, fast: bool) -> torch.Tensor:
    """The clipped controls ``[k, H, U]`` that K5 drew for rollouts
    ``flat_idx``; ``fast`` as the kernel's plant (``model.fast_math``)."""
    H, U = mue.shape
    z = normals_from_counter(cem_counters(seed2, flat_idx, K, H, U, tile_k), fast)
    return torch.clamp(mue + std * z, low, high)


def fused_cem_costs_plain(model: kernels.RolloutModel, s0, mue, std, pvec, seed2, low, high,
                          K: int, tile_k: int = DEFAULT_TILE_K) -> torch.Tensor:
    """The kernel's function in PyTorch: every row regenerated (the fast
    normals over a fast plant), then K1's plain rollout
    (pallas_cem.py:89-121)."""
    Q = regen_controls(seed2, torch.arange(K, device=mue.device), mue, std, low, high, K, tile_k,
                       fast=model.fast_math)
    return cost_rollout_plain(model, s0.expand(K, -1), Q, pvec)


def fused_cem_costs(model: kernels.RolloutModel, s0: torch.Tensor, mue: torch.Tensor,
                    std: torch.Tensor, pvec: torch.Tensor, seed2: torch.Tensor,
                    low: torch.Tensor, high: torch.Tensor, K: int,
                    tile_k: int = DEFAULT_TILE_K) -> torch.Tensor:
    """Per-rollout CEM cost ``[K]``; see the module docstring."""
    if (s0.ndim != 1 or mue.ndim != 2 or std.shape != mue.shape
            or low.shape != (mue.shape[1],) or high.shape != low.shape):
        raise ValueError(
            "fused_cem_costs: expected s0 [S], mue/std [H,U], low/high [U]; got "
            f"{tuple(s0.shape)}, {tuple(mue.shape)}, {tuple(std.shape)}, "
            f"{tuple(low.shape)}, {tuple(high.shape)}")
    check_tiling("fused_cem_costs", K, tile_k)
    if kernels.on_cpu(s0, mue, std, pvec, seed2, low, high):
        check_seed2("fused_cem_costs", seed2, torch.device("cpu"))
        return fused_cem_costs_plain(model, s0, mue, std, pvec, seed2, low, high, K, tile_k)
    kernels.require("K5", model.plant)
    device = kernels.check_cuda_operands("fused_cem_costs", s0=s0, mue=mue, std=std, pvec=pvec,
                                         low=low, high=high)
    check_seed2("fused_cem_costs", seed2, device)
    H, U = mue.shape
    model.check_launch_shape("fused_cem_costs", s0.shape[0], U, K, H, pvec.numel())
    cost = torch.empty(K, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_fused_cem(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), mue.data_ptr(), std.data_ptr(),
            pvec.data_ptr(), seed2.data_ptr(), low.data_ptr(), high.data_ptr(), cost.data_ptr(),
            K, H, tile_k, *model.step_args(), model.max_cost, int(model.fast_math),
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, "fused_cem_costs")
    fused_cem_costs.launches += 1
    return cost


fused_cem_costs.launches = 0
