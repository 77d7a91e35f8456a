// K1: rollout + trajectory cost over K control sequences.
//
// Replaces control_toolkit_tpu/ops/pallas_rollout.py:build_cost_rollout_kernel
// (the Pallas kernel behind kernel_families/ode.py:build_cost).  Python
// wrapper and plain version: ops/cost_rollout.py.
//
// cost[k] = (sum_h stage(x_h, Q[k,h], Q[k,h-1]) + terminal(x_H)) / (H+1)
// with Q[k,-1] = u_prev from the packed parameters.
//
// What bounds it on an H100: the serial H-step rk4 chain each thread runs
// in FP32 (four plant evaluations a step, each with sinf, cosf and three
// divisions); the bytes are small (Q is K*H*U floats, read once).  At the
// main path's K=16384 the grid is 128 blocks of 128 threads on 132 SMs,
// about four warps per SM, too few to hide the latency of that chain.
// The design does nothing about either yet: a first, simple kernel.
//
// Q is read strided in its [K, H, U] layout (thread k walks row k) instead
// of being transposed to [H, U, K] in the wrapper: a warp's loads at step h
// touch 32 sectors, but each 32-byte sector also holds the next steps'
// controls, which the following iterations then find in L1, so the extra
// transpose pass over Q would buy little.
#include "rollout_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kThreads)
cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                    const float* __restrict__ pvec, float* __restrict__ cost,
                    int K, int H, StepConsts c, float max_cost) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  Rollout<Plant> r;
  r.start(s0 + static_cast<size_t>(k) * Plant::S, p);
  const float* q = Q + static_cast<size_t>(k) * H * Plant::U;
  for (int h = 0; h < H; ++h) {
    float u[Plant::U];
#pragma unroll
    for (int j = 0; j < Plant::U; ++j) u[j] = __ldg(q + h * Plant::U + j);
    r.advance(u, p, c, max_cost);
  }
  cost[k] = r.finish(p, H);
}

}  // namespace ctt

// Launches K1 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                void* cost, int K, int H, int rk4, int substeps, float sub_dt,
                                float half_dt, float dt6, float max_cost, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      ctt::cost_rollout_kernel<ctt::CartpolePlant><<<grid, ctt::kThreads, 0, st>>>(
          static_cast<const float*>(s0), static_cast<const float*>(Q),
          static_cast<const float*>(pvec), static_cast<float*>(cost), K, H, c, max_cost);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
