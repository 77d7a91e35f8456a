// K6: fully-fused CEM for B independent sessions in one launch — K5's
// rollout body (cem_core.cuh) with each session's own initial state,
// distribution, packed parameters and seed, and session-local counters;
// only the [B, K] costs leave the kernel.
//
// Replaces control_toolkit_tpu/ops/pallas_cem.py:build_fused_cem_cols
// (kernel :236, call :304), the batched-mpc controller's fused CEM kernel.
// Python wrapper, plain version and the elite regeneration regen_cols:
// ops/fused_cem_cols.py.
//
// Thread g owns rollout k = g % K of session b = g / K, with k = r*cps + cw
// (cps = K/8, the JAX layout's sublane r and session-local column cw), and
// reads the session's rows by index: s0 [B, S], mue and std [B, H, U],
// pvec_b [B, N], seed_b [B] int32, cost [B, K].  Its counters are
//   seed_b*FNV + j*H*K + (h*8 + r)*cps + cw = (seed_b*FNV + k) + j*(H*K) + h*K
// in uint32 arithmetic (pallas_cem.py:248-251; the wrapper asks K % 8 == 0).
// There is no tile term, unlike K5's: a session's samples depend on its own
// seed and K only, so its results do not depend on B.  seed_b is read from
// device memory: seeds drawn on the card never go through the host.
//
// What bounds it on an H100 and what the design does about it: cem_core.cuh
// (K5's body, draws ahead into shared memory and short_step.cuh's step).
// At the fleet's H=35 one chunk of kDrawControls covers the horizon.  A
// block of kCemThreads rollouts may straddle two sessions where K is not a
// multiple of it, so each thread reads its rows by its own b.  Rollouts
// past B*K (the grid's ragged edge) repeat the last rollout and write
// nothing.  Its instances are K5's: every ODE plant, and the point mass's
// fast-normals instance, selected by the entry's `fast`.
#include "cem_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
fused_cem_cols_kernel(const float* __restrict__ s0, const float* __restrict__ mue,
                      const float* __restrict__ std_dev, const float* __restrict__ pvec_b,
                      const int* __restrict__ seed_b, const float* __restrict__ low,
                      const float* __restrict__ high, float* __restrict__ cost, int B, int K,
                      int H, StepConsts c, float max_cost) {
  __shared__ float drawn[kDrawControls][kCemThreads];
  const int n = B * K;
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < n ? g : n - 1;
  const int b = gc / K, k = gc % K;
  const uint32_t uK = static_cast<uint32_t>(K);
  const uint32_t base =
      static_cast<uint32_t>(__ldg(seed_b + b)) * kFnv + static_cast<uint32_t>(k);
  const size_t row = static_cast<size_t>(b) * H * Plant::U;
  const float out = cem_rollout_cost<Plant>(
      s0 + static_cast<size_t>(b) * Plant::S, mue + row, std_dev + row,
      pvec_b + static_cast<size_t>(b) * Plant::kN, low, high, base, static_cast<uint32_t>(H) * uK,
      uK, H, c, max_cost, &drawn[0][threadIdx.x]);
  if (g < n) cost[g] = out;
}

// K6 over `Plant` on `stream`.
template <class Plant>
int launch_fused_cem_cols(cudaStream_t st, const void* s0, const void* mue, const void* std_dev,
                          const void* pvec_b, const void* seed_b, const void* low,
                          const void* high, void* cost, int B, int K, int H, const StepConsts& c,
                          float max_cost) {
  const dim3 grid((B * K + kCemThreads - 1) / kCemThreads);
  fused_cem_cols_kernel<Plant><<<grid, kCemThreads, 0, st>>>(
      static_cast<const float*>(s0), static_cast<const float*>(mue),
      static_cast<const float*>(std_dev), static_cast<const float*>(pvec_b),
      static_cast<const int*>(seed_b), static_cast<const float*>(low),
      static_cast<const float*>(high), static_cast<float*>(cost), B, K, H, c, max_cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Launches K6 on `stream` over the fast normals where `fast` (a fast plant,
// or the point mass's fast-normals instance); returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown plant or a `fast`
// that does not fit it).
extern "C" int ctt_fused_cem_cols(int plant, const void* s0, const void* mue, const void* std_dev,
                                  const void* pvec_b, const void* seed_b, const void* low,
                                  const void* high, void* cost, int B, int K, int H, int rk4,
                                  int substeps, float sub_dt, float half_dt, float dt6,
                                  float max_cost, int fast, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  return ctt::with_fused_instance(plant, fast, [&](auto instance_tag) {
    return ctt::launch_fused_cem_cols<decltype(instance_tag)>(
        static_cast<cudaStream_t>(stream), s0, mue, std_dev, pvec_b, seed_b, low, high, cost, B,
        K, H, c, max_cost);
  });
}

// Blocks of K6 over `plant` (its fast-normals instance where `fast`) that
// one SM holds (0 where the runtime cannot say or there is no such
// instance).
extern "C" int ctt_fused_cem_cols_plant_blocks_per_sm(int plant, int fast) {
  int blocks = 0;
  const int rc = ctt::with_fused_instance(plant, fast, [&](auto instance_tag) {
    return ctt::blocks_per_sm(ctt::fused_cem_cols_kernel<decltype(instance_tag)>,
                              ctt::kCemThreads, blocks);
  });
  return rc == 0 ? blocks : 0;
}
