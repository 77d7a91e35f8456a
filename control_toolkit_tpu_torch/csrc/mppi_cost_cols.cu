// K4: the semi-fused MPPI cost of B independent sessions in one launch —
// K2's per-rollout arithmetic (mppi_core.cuh) with each session's own
// initial state, shifted nominal plan, packed parameters (attributes,
// previous control, per-slot dynamics constants) and noise.
//
// Replaces control_toolkit_tpu/ops/pallas_mppi.py:make_cost_run_cols
// (make_run.cols, kernel body kernel1_cols), the batched-mpc controller's
// MPPI kernel.  Python wrapper and plain version: ops/mppi_cost_cols.py.
//
// Thread g owns rollout k = g % K of session b = g / K and reads the
// session's rows by index: s0 [B, S], u_nom [B, H, U], pvec_b [B, N],
// eps [B, P, U, K] (rollout fastest, so a warp's loads of one (b, p, j)
// coalesce), cost [B, K].  The TPU kernel's per-column context rows and its
// lane-tile layout are not carried over: session b's rollout k is the JAX
// layout's (r, cw) with k = r*(K/8) + cw (ops/mppi_cost_cols.py).  Every
// scalar is read at run time from pvec_b, so a changed length, target or
// weight never rebuilds anything.
//
// What bounds it on an H100: K2's serial H-step rk4 chain per thread in
// FP32.  At B=128, K=512 the grid is 512 blocks of 128 threads on 132 SMs,
// four times K2's fill at K=16384, so more warps hide that chain's latency.
#include "mppi_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kThreads)
mppi_cost_cols_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                      const float* __restrict__ pvec_b, const float* __restrict__ eps,
                      const float* __restrict__ W, const float* __restrict__ low,
                      const float* __restrict__ high, float* __restrict__ cost, int B, int K,
                      int H, int P, StepConsts c, float max_cost, CorrConsts cc) {
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
  cost[g] = mppi_rollout_cost<Plant>(s0 + b * Plant::S, u_nom + static_cast<size_t>(b) * H * U, p,
                                     eps + static_cast<size_t>(b) * P * U * K, k, K, W, H, P, lo,
                                     hi, c, max_cost, cc);
}

}  // namespace ctt

// Launches K4 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_mppi_cost_cols(int plant, const void* s0, const void* u_nom,
                                  const void* pvec_b, const void* eps, const void* W,
                                  const void* low, const void* high, void* cost, int B, int K,
                                  int H, int P, int rk4, int substeps, float sub_dt, float half_dt,
                                  float dt6, float max_cost, float cc_weight, float c1, float r,
                                  float c3, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const ctt::CorrConsts cc{cc_weight, c1, r, c3};
  const dim3 grid((B * K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      ctt::mppi_cost_cols_kernel<ctt::CartpolePlant><<<grid, ctt::kThreads, 0, st>>>(
          static_cast<const float*>(s0), static_cast<const float*>(u_nom),
          static_cast<const float*>(pvec_b), static_cast<const float*>(eps),
          static_cast<const float*>(W), static_cast<const float*>(low),
          static_cast<const float*>(high), static_cast<float*>(cost), B, K, H, P, c, max_cost,
          cc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
