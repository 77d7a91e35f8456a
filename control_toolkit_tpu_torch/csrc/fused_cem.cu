// K5: fully-fused CEM — the population drawn in registers from the counter
// PRNG, clipped, rolled out and scored; only the [K] costs leave the kernel.
//
// Replaces control_toolkit_tpu/ops/pallas_cem.py:build_fused_cem (kernel
// :89-121, call :133).  Python wrapper, plain version and the elite
// regeneration: ops/fused_cem.py.  The per-rollout arithmetic is
// cem_core.cuh's, which K6 (fused_cem_cols.cu) shares.
//
// Thread g owns rollout g of the JAX cost order (counter_prng.cuh
// tile_coords: sublane r, tile t, lane c, C = tile_k / 8).  Its counters are
//   seed*FNV + (off+t)*H*tile_k*U + j*H*tile_k + h*tile_k + r*C + c
// in uint32 arithmetic (h*tile_k + r*C + c is (h*8 + r)*C + c).  seed2 =
// [seed, tile offset] is read from device memory: a seed drawn on the card
// is never copied to the host.
//
// What bounds it on an H100: the serial H-step rk4 chain, as K1, plus per
// control two splitmix32 hashes (three 32-bit multiplies, three shifts and
// three xors each) and a logf, sqrtf and cosf; the bytes are the [K] costs.
// The population never touches device memory, which is the point of the
// TPU kernel, and the design keeps it so.  Grid fill is K1's: at K=16384,
// 128 blocks of 128 threads on 132 SMs.
#include "cem_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kThreads)
fused_cem_kernel(const float* __restrict__ s0, const float* __restrict__ mue,
                 const float* __restrict__ std_dev, const float* __restrict__ pvec,
                 const int* __restrict__ seed2, const float* __restrict__ low,
                 const float* __restrict__ high, float* __restrict__ cost, int K, int H,
                 int tile_k, StepConsts c, float max_cost) {
  constexpr int U = Plant::U;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= K) return;
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  float lo[U], hi[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    lo[j] = __ldg(low + j);
    hi[j] = __ldg(high + j);
  }
  const int C = tile_k / kRows;
  const TileCoords tc = tile_coords(g, K, C);
  const uint32_t stride = static_cast<uint32_t>(H) * static_cast<uint32_t>(tile_k);
  const uint32_t base = static_cast<uint32_t>(__ldg(seed2)) * kFnv +
                        (static_cast<uint32_t>(__ldg(seed2 + 1)) + tc.t) * (stride * U) +
                        tc.r * static_cast<uint32_t>(C) + tc.c;
  cost[g] = cem_rollout_cost<Plant>(s0, mue, std_dev, p, lo, hi, base, stride,
                                    static_cast<uint32_t>(tile_k), H, c, max_cost);
}

}  // namespace ctt

// Launches K5 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_fused_cem(int plant, const void* s0, const void* mue, const void* std_dev,
                             const void* pvec, const void* seed2, const void* low,
                             const void* high, void* cost, int K, int H, int tile_k, int rk4,
                             int substeps, float sub_dt, float half_dt, float dt6, float max_cost,
                             void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      ctt::fused_cem_kernel<ctt::CartpolePlant><<<grid, ctt::kThreads, 0, st>>>(
          static_cast<const float*>(s0), static_cast<const float*>(mue),
          static_cast<const float*>(std_dev), static_cast<const float*>(pvec),
          static_cast<const int*>(seed2), static_cast<const float*>(low),
          static_cast<const float*>(high), static_cast<float*>(cost), K, H, tile_k, c, max_cost);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
