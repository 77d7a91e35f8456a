// K6: fully-fused CEM for B independent sessions in one launch — K5's
// per-rollout arithmetic (cem_core.cuh) with each session's own initial
// state, distribution, packed parameters and seed, and session-local
// counters; only the [B, K] costs leave the kernel.
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
// seed and K only, so its results do not depend on B.  seed_b is read from device memory: seeds drawn on the
// card never go through the host.
//
// What bounds it on an H100: K5's, the serial H-step rk4 chain and two
// splitmix32 hashes, a logf, sqrtf and cosf per control.  At B=128, K=512
// the grid is 512 blocks of 128 threads on 132 SMs, four times K5's fill at
// K=16384.
#include "cem_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kThreads)
fused_cem_cols_kernel(const float* __restrict__ s0, const float* __restrict__ mue,
                      const float* __restrict__ std_dev, const float* __restrict__ pvec_b,
                      const int* __restrict__ seed_b, const float* __restrict__ low,
                      const float* __restrict__ high, float* __restrict__ cost, int B, int K,
                      int H, StepConsts c, float max_cost) {
  constexpr int U = Plant::U;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= B * K) return;  // ragged B*K is masked
  const int b = g / K, k = g % K;
  float p[Plant::kN];
  load_params<Plant>(pvec_b + static_cast<size_t>(b) * Plant::kN, p);
  float lo[U], hi[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    lo[j] = __ldg(low + j);
    hi[j] = __ldg(high + j);
  }
  const uint32_t uK = static_cast<uint32_t>(K);
  const uint32_t base =
      static_cast<uint32_t>(__ldg(seed_b + b)) * kFnv + static_cast<uint32_t>(k);
  const size_t row = static_cast<size_t>(b) * H * U;
  cost[g] = cem_rollout_cost<Plant>(s0 + b * Plant::S, mue + row, std_dev + row, p, lo, hi, base,
                                    static_cast<uint32_t>(H) * uK, uK, H, c, max_cost);
}

}  // namespace ctt

// Launches K6 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_fused_cem_cols(int plant, const void* s0, const void* mue, const void* std_dev,
                                  const void* pvec_b, const void* seed_b, const void* low,
                                  const void* high, void* cost, int B, int K, int H, int rk4,
                                  int substeps, float sub_dt, float half_dt, float dt6,
                                  float max_cost, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((B * K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      ctt::fused_cem_cols_kernel<ctt::CartpolePlant><<<grid, ctt::kThreads, 0, st>>>(
          static_cast<const float*>(s0), static_cast<const float*>(mue),
          static_cast<const float*>(std_dev), static_cast<const float*>(pvec_b),
          static_cast<const int*>(seed_b), static_cast<const float*>(low),
          static_cast<const float*>(high), static_cast<float*>(cost), B, K, H, c, max_cost);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
