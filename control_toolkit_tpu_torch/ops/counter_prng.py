"""The counter PRNG of the fully-fused kernels (counterpart of
control_toolkit_tpu/ops/pallas_mppi.py:58-122: ``_splitmix32``,
``_normals_from_counter``, ``_normals``).

Each standard normal is a pure function of one uint32 counter: two
splitmix32 hashes (of the counter and of the counter plus 0x7F4A7C15)
give the top-24-bit uniforms ``u1 = (i1 + 1) * 2^-24`` in (0, 1] and
``u2 = i2 * 2^-24`` in [0, 1), and Box-Muller gives ``sqrt(-2 log u1) *
cos(2 pi u2)``.  So a kernel can draw its noise in registers and any subset
of it can be regenerated from the same counters (K5's elite rows, K3's
second pass).  The device twin is ``csrc/counter_prng.cuh``.

torch has no complete uint32 arithmetic: the counters ride in int64, every
result is masked to 32 bits, and each 32x32-bit multiply by a constant is
split into the constant's 16-bit halves, so that no int64 product
overflows.  ``fast=True`` is the ``fast_sampling`` form:
``sqrt(max(-2 fast_log(u1), 0)) * fast_cos(2 pi u2)`` over
ops/fastmath.py's polynomials (the clamp keeps u1 = 1.0, where fast_log
lands at +2e-6, from a NaN); the fast plant's kernels draw it, and their
regenerations must pass the same flag.
"""
from __future__ import annotations

import torch

from control_toolkit_tpu_torch.ops.fastmath import fast_cos, fast_log

DEFAULT_TILE_K = 2048
ROWS = 8  # the TPU tile's sublanes: rollout (tile t, row r, column c) of [ROWS, tile_k/ROWS]
FNV = 0x01000193  # the seed's multiplier in every counter base
MASK = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
_INV_2_24 = 1.0 / 16777216.0


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c`` in [0, 2^32): ``x*lo + ((x*hi) mod 2^16) << 16`` with ``c =
    hi*2^16 + lo``, each product below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """The splitmix32 finalizer on int64 counters in [0, 2^32)."""
    x = mul32(x, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def normals_from_counter(counter: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """A float32 standard normal for each int64 counter (taken mod 2^32),
    in the JAX function's order of operations; ``fast``: the polynomial
    log and cos."""
    counter = counter & MASK
    i1 = splitmix32(counter) >> 8
    i2 = splitmix32((counter + 0x7F4A7C15) & MASK) >> 8
    u1 = (i1.to(torch.float32) + 1.0) * _INV_2_24
    u2 = i2.to(torch.float32) * _INV_2_24
    if fast:
        r = torch.sqrt(torch.clamp_min(-2.0 * fast_log(u1), 0.0))
        return r * fast_cos(_TWO_PI * u2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)


def normals(counter_base, shape, device=None) -> torch.Tensor:
    """``[R, C]`` normals keyed by ``counter_base + r*C + c`` (``_normals``'
    layout); ``counter_base`` an int or an int64 tensor."""
    rows, cols = shape
    idx = torch.arange(rows * cols, dtype=torch.int64, device=device).reshape(rows, cols)
    return normals_from_counter(idx + counter_base)


def draw_seed2(generator: torch.Generator, device) -> torch.Tensor:
    """The fused kernels' ``seed2 = [seed, 0]`` (int32, on ``device``): a
    seed in [0, 2^31 - 1) as the JAX steps draw it with ``randint``, made
    on the device so that it never goes through the host."""
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, dtype=torch.int32,
                         device=device)
    return torch.cat([seed, torch.zeros(1, dtype=torch.int32, device=device)])


def seed_base(seed2: torch.Tensor) -> tuple:
    """``seed * FNV mod 2^32`` and the tile offset, as int64 scalars, from
    the kernels' int32 ``seed2 = [seed, tile_offset]``."""
    s = seed2.to(torch.int64) & MASK
    return mul32(s[0], FNV), s[1]


def rollout_coords(flat_idx: torch.Tensor, K: int, tile_k: int):
    """``(r, t, c)`` of the rollouts at ``flat_idx`` of the kernels' cost
    order (JAX's ``costs2d [ROWS, K/ROWS]`` flattened row-major):
    ``r = g // (K/ROWS)``, ``t = (g % (K/ROWS)) // C``, ``c = g % C`` with
    ``C = tile_k/ROWS``."""
    C = tile_k // ROWS
    TC = K // ROWS
    rem = flat_idx % TC
    return flat_idx // TC, rem // C, rem % C
