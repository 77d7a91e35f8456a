// The counter PRNG of the fully-fused kernels (K5 fused_cem.cu, K3
// fused_mppi.cu): a standard normal as a pure function of one uint32
// counter, so a kernel draws its noise in registers and any subset of it
// can be drawn again from the same counters.  Device twin of
// ops/counter_prng.py, which copies control_toolkit_tpu/ops/pallas_mppi.py
// _splitmix32 and _normals_from_counter.
//
// logf, sqrtf and cosf are the accurate library functions: the kernels are
// not compiled with --use_fast_math (ops/kernels.py NVCC_FLAGS), so the
// card's normals are the ones torch computes from the same counters.  The
// fast form (counter_normal<true>, JAX's fast_sampling) takes fastmath.cuh's
// fast_log and fast_cos, every step rounded apart, so the card's torch
// regeneration (``normals_from_counter(..., fast=True)``) draws it bit for
// bit too; the kernels over the fast plant draw it (Plant::kFast).
#pragma once

#include <cstdint>

#include "fastmath.cuh"

namespace ctt {

constexpr uint32_t kFnv = 0x01000193u;  // the seed's multiplier in every counter base
constexpr int kRows = 8;                 // ops/counter_prng.py ROWS

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x *= 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Box-Muller on the top 24 bits of two hashes: u1 in (0, 1], u2 in [0, 1).
// The integers are below 2^24, so every step up to the logarithm is exact.
// Fast: sqrt(max(-2 fast_log(u1), 0)) * fast_cos(2 pi u2); fast_log(1.0)
// lands at +2e-6, so the radicand is clamped at 0 (pallas_mppi.py:105-112).
template <bool Fast = false>
__device__ __forceinline__ float counter_normal(uint32_t counter) {
  const uint32_t i1 = splitmix32(counter) >> 8;
  const uint32_t i2 = splitmix32(counter + 0x7F4A7C15u) >> 8;
  const float u1 = (static_cast<float>(i1) + 1.0f) * (1.0f / 16777216.0f);
  const float u2 = static_cast<float>(i2) * (1.0f / 16777216.0f);
  if constexpr (Fast) {
    const float r = sqrtf(fmaxf(__fmul_rn(-2.0f, fast_log(u1)), 0.0f));
    return __fmul_rn(r, fast_cos(__fmul_rn(fastmath::kTwoPiF, u2)));
  } else {
    const float r = sqrtf(-2.0f * logf(u1));
    return r * cosf(6.283185307179586f * u2);
  }
}

// Rollout g of the kernels' cost order (JAX's costs2d [kRows, K/kRows]
// flattened row-major): sublane r, tile t, lane c of a tile of kRows x C.
struct TileCoords {
  uint32_t r, t, c;
};

__device__ __forceinline__ TileCoords tile_coords(int g, int K, int C) {
  const int cols = K / kRows;
  const int rem = g % cols;
  return {static_cast<uint32_t>(g / cols), static_cast<uint32_t>(rem / C),
          static_cast<uint32_t>(rem % C)};
}

}  // namespace ctt
