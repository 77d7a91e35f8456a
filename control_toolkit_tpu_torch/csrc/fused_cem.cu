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
// (the body K6 shares).  Its tile layout is K5's own.  Over a fast plant
// (CartpoleFastPlant, kPlantCartpoleFast, and every plant's fast plant) it
// is the JAX fast_sampling form: fast trig in the plant, the fast normals
// in the draws.  Every ODE plant of plants.cuh has an instance
// (rollout_core.cuh with_fused_instance); the point mass, whose exact
// dynamics double as the fast ones, has a second, its fast-normals
// instance (FastNormalsOf), which the entry's `fast` selects, as K3's pass
// 1 does.  Rollouts past K (a block's ragged edge) repeat rollout K-1 and
// write nothing.
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

// K5 over `Plant` on `stream`.
template <class Plant>
int launch_fused_cem(cudaStream_t st, const void* s0, const void* mue, const void* std_dev,
                     const void* pvec, const void* seed2, const void* low, const void* high,
                     void* cost, int K, int H, int tile_k, const StepConsts& c, float max_cost) {
  fused_cem_kernel<Plant><<<(K + kCemThreads - 1) / kCemThreads, kCemThreads, 0, st>>>(
      static_cast<const float*>(s0), static_cast<const float*>(mue),
      static_cast<const float*>(std_dev), static_cast<const float*>(pvec),
      static_cast<const int*>(seed2), static_cast<const float*>(low),
      static_cast<const float*>(high), static_cast<float*>(cost), K, H, tile_k, c, max_cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Launches K5 on `stream` over the fast normals where `fast` (a fast plant,
// or the point mass's fast-normals instance); returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown plant or a `fast`
// that does not fit it).
extern "C" int ctt_fused_cem(int plant, const void* s0, const void* mue, const void* std_dev,
                             const void* pvec, const void* seed2, const void* low,
                             const void* high, void* cost, int K, int H, int tile_k, int rk4,
                             int substeps, float sub_dt, float half_dt, float dt6, float max_cost,
                             int fast, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  return ctt::with_fused_instance(plant, fast, [&](auto instance_tag) {
    return ctt::launch_fused_cem<decltype(instance_tag)>(
        static_cast<cudaStream_t>(stream), s0, mue, std_dev, pvec, seed2, low, high, cost, K, H,
        tile_k, c, max_cost);
  });
}

// Blocks of K5 over `plant` (its fast-normals instance where `fast`) that
// one SM holds (0 where the runtime cannot say or there is no such
// instance).
extern "C" int ctt_fused_cem_plant_blocks_per_sm(int plant, int fast) {
  int blocks = 0;
  const int rc = ctt::with_fused_instance(plant, fast, [&](auto instance_tag) {
    return ctt::blocks_per_sm(ctt::fused_cem_kernel<decltype(instance_tag)>, ctt::kCemThreads,
                              blocks);
  });
  return rc == 0 ? blocks : 0;
}
