// K5: fully-fused CEM — the population drawn on the card from the counter
// PRNG, clipped, rolled out and scored; only the [K] costs leave the kernel.
//
// Replaces control_toolkit_tpu/ops/pallas_cem.py:build_fused_cem (kernel
// :89-121, call :133).  Python wrapper, plain version and the elite
// regeneration: ops/fused_cem.py.  The control of each counter is
// cem_core.cuh's cem_control, which K6 (fused_cem_cols.cu) shares.
//
// Rollout g follows the JAX cost order (counter_prng.cuh tile_coords:
// sublane r, tile t, lane c, C = tile_k / 8).  Its counters are
//   seed*FNV + (off+t)*H*tile_k*U + j*H*tile_k + h*tile_k + r*C + c
// in uint32 arithmetic (h*tile_k + r*C + c is (h*8 + r)*C + c).  seed2 =
// [seed, tile offset] is read from device memory: a seed drawn on the card
// is never copied to the host.
//
// What bounds it on an H100 and what the design does about it: cem_core.cuh
// (the body K6 shares).  Its tile layout is K5's own.  Over the fast plant
// (CartpoleFastPlant, kPlantCartpoleFast) it is the JAX fast_sampling
// form: fast_sincos in the plant, the fast normals in the draws.  Rollouts past K (a
// block's ragged edge) repeat rollout K-1 and write nothing.
#include "cem_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
fused_cem_kernel(const float* __restrict__ s0, const float* __restrict__ mue,
                 const float* __restrict__ std_dev, const float* __restrict__ pvec,
                 const int* __restrict__ seed2, const float* __restrict__ low,
                 const float* __restrict__ high, float* __restrict__ cost, int K, int H,
                 int tile_k, StepConsts c, float max_cost) {
  __shared__ float drawn[kDrawControls][kCemThreads];
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < K ? g : K - 1;
  const int C = tile_k / kRows;
  const TileCoords tc = tile_coords(gc, K, C);
  const uint32_t stride = static_cast<uint32_t>(H) * static_cast<uint32_t>(tile_k);
  const uint32_t base = static_cast<uint32_t>(__ldg(seed2)) * kFnv +
                        (static_cast<uint32_t>(__ldg(seed2 + 1)) + tc.t) * (stride * Plant::U) +
                        tc.r * static_cast<uint32_t>(C) + tc.c;
  const float out = cem_rollout_cost<Plant>(s0, mue, std_dev, pvec, low, high, base, stride,
                                            static_cast<uint32_t>(tile_k), H, c, max_cost,
                                            &drawn[0][threadIdx.x]);
  if (g < K) cost[g] = out;
}

}  // namespace ctt

// Launches K5 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_fused_cem(int plant, const void* s0, const void* mue, const void* std_dev,
                             const void* pvec, const void* seed2, const void* low,
                             const void* high, void* cost, int K, int H, int tile_k, int rk4,
                             int substeps, float sub_dt, float half_dt, float dt6, float max_cost,
                             void* stream) {
  if (plant != ctt::kPlantCartpole && plant != ctt::kPlantCartpoleFast) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  constexpr int per_block = ctt::kCemThreads;
  (plant == ctt::kPlantCartpole ? ctt::fused_cem_kernel<ctt::CartpolePlant>
                                : ctt::fused_cem_kernel<ctt::CartpoleFastPlant>)
      <<<(K + per_block - 1) / per_block, per_block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(s0), static_cast<const float*>(mue),
          static_cast<const float*>(std_dev), static_cast<const float*>(pvec),
          static_cast<const int*>(seed2), static_cast<const float*>(low),
          static_cast<const float*>(high), static_cast<float*>(cost), K, H, tile_k, c, max_cost);
  return static_cast<int>(cudaGetLastError());
}
