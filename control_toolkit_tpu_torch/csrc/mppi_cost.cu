// K2: the semi-fused MPPI cost — interpolation of inducing-point noise,
// clip, rollout, stage cost and MPPI correction cost, fused per rollout.
//
// Replaces control_toolkit_tpu/ops/pallas_mppi.py:make_cost_run
// (make_run.external, kernel body kernel1_ext over rollout_cost_core), the
// default MPPI step's kernel.  Python wrapper and plain version:
// ops/mppi_cost.py.
//
// For rollout k and step h, with p0 <= p1 = p0+1 the inducing points that
// bracket h in the [P, H] interpolation matrix W:
//   d_j   = W[p0,h] * eps[p0,j,k] + W[p1,h] * eps[p1,j,k]
//   u_j   = clamp(u_nom[h,j] + d_j, low[j], high[j])
//   corr += cc * ((c1*d_j)*d_j + (r*u_j)*d_j + (c3*u_j)*u_j)
//           with c1 = 0.5*(1-1/NU)*R, r = R, c3 = 0.5*R
// cost[k] = (sum_h stage + terminal) / (H+1) + corr   (corr is not averaged)
//
// eps is [P, U, K] with the rollout index fastest, so a warp's 32 loads of
// one (p, j) are 128 contiguous bytes.  W is read from the matrix itself
// (not recomputed from the period), so the kernel uses the same float32
// weights as the reference.
//
// What bounds it on an H100: as K1 (cost_rollout.cu), the serial H-step
// rk4 chain per thread in FP32; the eps reads are 2*H*U coalesced loads
// per rollout.  At K=16384 the grid is 128 blocks of 128 threads for 132
// SMs, about four warps per SM, which cannot hide that chain's latency.
// Nothing in the design addresses it yet.
#include "rollout_core.cuh"

namespace ctt {

struct CorrConsts {
  float cc, c1, r, c3;
};

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
  Rollout<Plant> r;
  r.start(s0, p);
  float corr = 0.0f;
  int p0 = 0;
  for (int h = 0; h < H; ++h) {
    // The left bracket moves right where its weight has dropped to zero.
    while (p0 + 1 < P && __ldg(W + p0 * H + h) == 0.0f) ++p0;
    const bool two = p0 + 1 < P;
    const float w0 = __ldg(W + p0 * H + h);
    const float w1 = two ? __ldg(W + (p0 + 1) * H + h) : 0.0f;
    float u[U], d[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      float dj = w0 * __ldg(eps + (static_cast<size_t>(p0) * U + j) * K + k);
      if (two) dj = dj + w1 * __ldg(eps + (static_cast<size_t>(p0 + 1) * U + j) * K + k);
      d[j] = dj;
      u[j] = fminf(fmaxf(__ldg(u_nom + h * U + j) + dj, lo[j]), hi[j]);
    }
    r.advance(u, p, c, max_cost);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      corr = corr + cc.cc * ((cc.c1 * d[j] * d[j] + cc.r * u[j] * d[j]) + cc.c3 * u[j] * u[j]);
    }
  }
  cost[k] = r.finish(p, H) + corr;
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
