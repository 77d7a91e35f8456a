"""K3: the fully-fused MPPI step — the counterpart of
control_toolkit_tpu/ops/pallas_mppi.py:build_fused_mppi_step's ``make_run``
(single-device form, ``mesh=None``).

The noise of rollout g (the JAX ``costs2d.reshape(-1)`` order: sublane r,
tile t, lane c, ``C = tile_k/ROWS``) at inducing point p and input j is

    e[p,j] = stdev * normal(seed*FNV + (off+t)*P*tile_k*U + j*P*tile_k + (p*ROWS + r)*C + c)

(``seed2 = [seed, off]``, ``ops/counter_prng.py``).  Two kernels and the
glue between them:

* pass 1, ``fused_mppi_costs(model, s0 [S], u_nom [H,U], pvec, seed2, W
  [P,H], low, high, cc_weight, R, NU, stdev, K, tile_k) -> cost [K]``: K2's
  function (``ops/mppi_cost.py``) over that noise, drawn in the kernel
  with the controls ahead of the steps (``csrc/mppi_ahead.cuh``); at
  ``cc_weight = 0`` its costs are K1's over ``mppi_controls_plain``'s
  controls of that noise;
* ``rho = min S`` and ``a = sum exp(-(S - rho)/LBD)`` in torch on the
  device, as XLA computes them in JAX, passed on as ``red = [rho, a]``;
* pass 2, ``fused_mppi_weights(seed2, cost, red, P, U, LBD, K, tile_k, fast=) ->
  partials [n_blocks, P, U]``: per block of ``WEIGHT_BLOCK`` rollouts,
  ``sum_k w_k z_k[p,j]`` with ``w = exp(-(S - rho)/LBD)/a`` and the noise
  drawn again from the same counters (unscaled);
* the update, in torch: ``b[h,j] = sum_p W[p,h] * stdev * sum_blocks
  partials[.,p,j]`` and ``u_nom' = clamp(u_nom + b, low, high)`` — the
  JAX kernel's ``sum_k w_k delta_k[h]`` by the linearity of interpolation.

Over a fast plant (``model.fast_math``, the ``:fast`` predictors) both
passes draw the fast normals (the JAX ``fast_sampling`` form): pass 1
takes it from the plant, pass 2 from its ``fast`` flag, which
``fused_mppi_step`` sets from the same model; the flag has no default, so
that no caller draws exact normals for rows a fast kernel scored.

``fused_mppi_step`` is that composition, ``(u_nom' [H,U], cost [K])``;
``fused_mppi_step_plain`` the same over the plain versions,
``fused_mppi_costs_plain`` and ``fused_mppi_weights_plain``.  The CUDA
kernels are ``csrc/fused_mppi.cu``.  Each wrapper runs its plain version
only when every operand lies on the CPU; for CUDA operands it launches its
kernel or raises.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.counter_prng import (
    DEFAULT_TILE_K, ROWS, normals_from_counter, rollout_coords, seed_base,
)
from control_toolkit_tpu_torch.ops.fused_cem import check_seed2, check_tiling
from control_toolkit_tpu_torch.ops.mppi_cost import _corr_consts, mppi_cost_plain

WEIGHT_BLOCK = 128  # rollouts per partial sum of pass 2 (csrc/rollout_core.cuh kThreads)


def mppi_counters(seed2: torch.Tensor, K: int, P: int, U: int, tile_k: int) -> torch.Tensor:
    """The int64 counters ``[P, U, K]`` of every rollout's noise."""
    C = tile_k // ROWS
    stride = P * tile_k  # counters per (tile, input)
    base, off = seed_base(seed2)
    r, t, c = rollout_coords(torch.arange(K, dtype=torch.int64, device=seed2.device), K, tile_k)
    row = base + (off + t) * (stride * U) + r * C + c                          # [K]
    p = torch.arange(P, dtype=torch.int64, device=seed2.device)
    j = torch.arange(U, dtype=torch.int64, device=seed2.device)
    return row[None, None, :] + p[:, None, None] * tile_k + j[None, :, None] * stride


def mppi_noise(seed2, K: int, P: int, U: int, tile_k: int, *, fast: bool) -> torch.Tensor:
    """The unscaled normals ``z [P, U, K]`` both passes draw (``fast``: the
    fast normals, over a fast plant)."""
    return normals_from_counter(mppi_counters(seed2, K, P, U, tile_k), fast)


def fused_mppi_costs_plain(model: kernels.RolloutModel, s0, u_nom, pvec, seed2, W, low, high,
                           cc_weight: float, R: float, NU: float, stdev: float, K: int,
                           tile_k: int = DEFAULT_TILE_K) -> torch.Tensor:
    """Pass 1 in PyTorch: K2's plain version over the regenerated noise,
    scaled as ``normal * stdev`` (pallas_mppi.py:208)."""
    eps = mppi_noise(seed2, K, W.shape[0], u_nom.shape[1], tile_k, fast=model.fast_math) * stdev
    return mppi_cost_plain(model, s0, u_nom, pvec, eps, W, low, high, cc_weight, R, NU)


def fused_mppi_weights_plain(seed2, cost, red, P: int, U: int, LBD: float, K: int,
                             tile_k: int = DEFAULT_TILE_K, *, fast: bool) -> torch.Tensor:
    """Pass 2 in PyTorch: ``partials [n_blocks, P, U]`` of ``w * z`` over
    each block of WEIGHT_BLOCK rollouts (pallas_mppi.py:356-374)."""
    w = torch.exp(-(cost - red[0]) * (1.0 / LBD)) / red[1]                     # [K]
    wz = (mppi_noise(seed2, K, P, U, tile_k, fast=fast) * w).permute(2, 0, 1)       # [K, P, U]
    n_blocks = -(-K // WEIGHT_BLOCK)
    pad = n_blocks * WEIGHT_BLOCK - K
    if pad:
        wz = torch.cat([wz, wz.new_zeros(pad, P, U)])
    return wz.reshape(n_blocks, WEIGHT_BLOCK, P, U).sum(1)


def fused_mppi_costs(model: kernels.RolloutModel, s0: torch.Tensor, u_nom: torch.Tensor,
                     pvec: torch.Tensor, seed2: torch.Tensor, W: torch.Tensor, low: torch.Tensor,
                     high: torch.Tensor, cc_weight: float, R: float, NU: float, stdev: float,
                     K: int, tile_k: int = DEFAULT_TILE_K) -> torch.Tensor:
    """K3's pass 1: per-rollout MPPI cost ``[K]``."""
    if (s0.ndim != 1 or u_nom.ndim != 2 or W.ndim != 2 or W.shape[1] != u_nom.shape[0]
            or low.shape != (u_nom.shape[1],) or high.shape != low.shape):
        raise ValueError(
            "fused_mppi_costs: expected s0 [S], u_nom [H,U], W [P,H], low/high [U]; got "
            f"{tuple(s0.shape)}, {tuple(u_nom.shape)}, {tuple(W.shape)}, "
            f"{tuple(low.shape)}, {tuple(high.shape)}")
    check_tiling("fused_mppi_costs", K, tile_k)
    if kernels.on_cpu(s0, u_nom, pvec, seed2, W, low, high):
        check_seed2("fused_mppi_costs", seed2, torch.device("cpu"))
        return fused_mppi_costs_plain(model, s0, u_nom, pvec, seed2, W, low, high, cc_weight, R,
                                      NU, stdev, K, tile_k)
    kernels.require("K3", model.plant)
    device = kernels.check_cuda_operands("fused_mppi_costs", s0=s0, u_nom=u_nom, pvec=pvec, W=W,
                                         low=low, high=high)
    check_seed2("fused_mppi_costs", seed2, device)
    H, U = u_nom.shape
    model.check_launch_shape("fused_mppi_costs", s0.shape[0], U, K, H, pvec.numel())
    cost = torch.empty(K, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_fused_mppi_cost(
            kernels.PLANT_IDS[model.plant], s0.data_ptr(), u_nom.data_ptr(), pvec.data_ptr(),
            seed2.data_ptr(), W.data_ptr(), low.data_ptr(), high.data_ptr(), cost.data_ptr(),
            K, H, W.shape[0], tile_k, *model.step_args(), model.max_cost,
            *_corr_consts(cc_weight, R, NU), stdev, int(model.fast_math),
            torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, "fused_mppi_costs")
    fused_mppi_costs.launches += 1
    return cost


fused_mppi_costs.launches = 0


def fused_mppi_weights(seed2: torch.Tensor, cost: torch.Tensor, red: torch.Tensor, P: int,
                       U: int, LBD: float, K: int, tile_k: int = DEFAULT_TILE_K, *,
                       fast: bool) -> torch.Tensor:
    """K3's pass 2: ``partials [n_blocks, P, U]``; see the module docstring.
    ``fast`` draws the fast normals (pass 1's plant's ``fast_math``)."""
    if cost.shape != (K,) or red.shape != (2,) or P < 1 or U < 1:
        raise ValueError(f"fused_mppi_weights: expected cost [{K}], red [2]; got "
                         f"{tuple(cost.shape)}, {tuple(red.shape)} (P={P}, U={U})")
    check_tiling("fused_mppi_weights", K, tile_k)
    if kernels.on_cpu(seed2, cost, red):
        check_seed2("fused_mppi_weights", seed2, torch.device("cpu"))
        return fused_mppi_weights_plain(seed2, cost, red, P, U, LBD, K, tile_k, fast=fast)
    device = kernels.check_cuda_operands("fused_mppi_weights", cost=cost, red=red)
    check_seed2("fused_mppi_weights", seed2, device)
    partials = torch.empty(-(-K // WEIGHT_BLOCK), P, U, dtype=torch.float32, device=device)
    lib = kernels.load()
    with torch.cuda.device(device):
        rc = lib.ctt_fused_mppi_weights(
            seed2.data_ptr(), cost.data_ptr(), red.data_ptr(), partials.data_ptr(), K, P, U,
            tile_k, 1.0 / LBD, int(fast), torch.cuda.current_stream(device).cuda_stream,
        )
    kernels.check_launch(rc, "fused_mppi_weights")
    fused_mppi_weights.launches += 1
    return partials


fused_mppi_weights.launches = 0


def _step(costs_fn, weights_fn, model, s0, u_nom, pvec, seed2, W, low, high, cc_weight, R, NU,
          LBD, stdev, K, tile_k):
    P, U = W.shape[0], u_nom.shape[1]
    cost = costs_fn(model, s0, u_nom, pvec, seed2, W, low, high, cc_weight, R, NU, stdev, K,
                    tile_k)
    rho = torch.amin(cost)
    red = torch.stack([rho, torch.sum(torch.exp(-(cost - rho) / LBD))])
    zsum = weights_fn(seed2, cost, red, P, U, LBD, K, tile_k, fast=model.fast_math).sum(0)  # [P, U]
    b = torch.einsum("ph,pu->hu", W, stdev * zsum)
    return torch.clamp(u_nom + b, low, high), cost


def fused_mppi_step(model: kernels.RolloutModel, s0, u_nom, pvec, seed2, W, low, high,
                    cc_weight: float, R: float, NU: float, LBD: float, stdev: float, K: int,
                    tile_k: int = DEFAULT_TILE_K):
    """One fully-fused MPPI update: ``(u_nom' [H,U], cost [K])``."""
    return _step(fused_mppi_costs, fused_mppi_weights, model, s0, u_nom, pvec, seed2, W, low,
                 high, cc_weight, R, NU, LBD, stdev, K, tile_k)


def fused_mppi_step_plain(model: kernels.RolloutModel, s0, u_nom, pvec, seed2, W, low, high,
                          cc_weight: float, R: float, NU: float, LBD: float, stdev: float, K: int,
                          tile_k: int = DEFAULT_TILE_K):
    """``fused_mppi_step`` over the plain versions, on any device."""
    return _step(fused_mppi_costs_plain, fused_mppi_weights_plain, model, s0, u_nom, pvec, seed2,
                 W, low, high, cc_weight, R, NU, LBD, stdev, K, tile_k)
