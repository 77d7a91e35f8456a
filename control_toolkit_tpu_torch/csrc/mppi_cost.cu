// K2: the semi-fused MPPI cost — interpolation of inducing-point noise,
// clip, rollout, stage cost and MPPI correction cost, fused per rollout.
//
// Replaces control_toolkit_tpu/ops/pallas_mppi.py:make_cost_run
// (make_run.external, kernel body kernel1_ext over rollout_cost_core), the
// default MPPI step's kernel.  Python wrapper and plain version:
// ops/mppi_cost.py.  The per-rollout arithmetic is mppi_core.cuh's, which
// K4 (mppi_cost_cols.cu) shares.
//
// What bounds it on an H100: as K1 (cost_rollout.cu), the serial H-step
// rk4 chain per thread in FP32; the eps reads are 2*H*U coalesced loads
// per rollout.  At K=16384 the grid is 128 blocks of 128 threads for 132
// SMs, about four warps per SM, which cannot hide that chain's latency.
// Nothing in the design addresses it yet.
#include "mppi_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kThreads)
mppi_cost_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                 const float* __restrict__ pvec, const float* __restrict__ eps,
                 const float* __restrict__ W, const float* __restrict__ low,
                 const float* __restrict__ high, float* __restrict__ cost,
                 int K, int H, int P, StepConsts c, float max_cost, CorrConsts cc) {
  constexpr int U = Plant::U;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  float lo[U], hi[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    lo[j] = __ldg(low + j);
    hi[j] = __ldg(high + j);
  }
  cost[k] = mppi_rollout_cost<Plant>(s0, u_nom, p, eps, k, K, W, H, P, lo, hi, c, max_cost, cc);
}

}  // namespace ctt

// Launches K2 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_mppi_cost(int plant, const void* s0, const void* u_nom, const void* pvec,
                             const void* eps, const void* W, const void* low, const void* high,
                             void* cost, int K, int H, int P, int rk4, int substeps, float sub_dt,
                             float half_dt, float dt6, float max_cost, float cc_weight, float c1,
                             float r, float c3, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const ctt::CorrConsts cc{cc_weight, c1, r, c3};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      ctt::mppi_cost_kernel<ctt::CartpolePlant><<<grid, ctt::kThreads, 0, st>>>(
          static_cast<const float*>(s0), static_cast<const float*>(u_nom),
          static_cast<const float*>(pvec), static_cast<const float*>(eps),
          static_cast<const float*>(W), static_cast<const float*>(low),
          static_cast<const float*>(high), static_cast<float*>(cost), K, H, P, c, max_cost, cc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
