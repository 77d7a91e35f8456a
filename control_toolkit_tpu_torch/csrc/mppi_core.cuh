// The semi-fused MPPI cost of one rollout, shared by K2 (mppi_cost.cu, one
// session) and K4 (mppi_cost_cols.cu, B sessions): interpolation of the
// inducing-point noise, clip, rollout, stage cost and MPPI correction cost
// (control_toolkit_tpu/ops/pallas_mppi.py:rollout_cost_core).
//
// For step h, with p0 <= p1 = p0+1 the inducing points that bracket h in the
// [P, H] interpolation matrix W:
//   d_j   = W[p0,h] * eps[p0,j,k] + W[p1,h] * eps[p1,j,k]
//   u_j   = clamp(u_nom[h,j] + d_j, low[j], high[j])
//   corr += cc * ((c1*d_j)*d_j + (r*u_j)*d_j + (c3*u_j)*u_j)
//           with c1 = 0.5*(1-1/NU)*R, r = R, c3 = 0.5*R
// cost = (sum_h stage + terminal) / (H+1) + corr   (corr is not averaged)
//
// eps is the session's [P, U, K] block with the rollout index fastest, so a
// warp's 32 loads of one (p, j) are 128 contiguous bytes.  W is read from
// the matrix itself (not recomputed from the period), so the kernels use
// the same float32 weights as the reference.
#pragma once

#include "rollout_core.cuh"

namespace ctt {

struct CorrConsts {
  float cc, c1, r, c3;
};

// Rollout k of a session: s0 [S], u_nom [H, U], its packed parameters p
// (registers), eps [P, U, K].
template <class Plant>
__device__ __forceinline__ float mppi_rollout_cost(const float* __restrict__ s0,
                                                   const float* __restrict__ u_nom,
                                                   const float (&p)[Plant::kN],
                                                   const float* __restrict__ eps, int k, int K,
                                                   const float* __restrict__ W, int H, int P,
                                                   const float (&lo)[Plant::U],
                                                   const float (&hi)[Plant::U],
                                                   const StepConsts& c, float max_cost,
                                                   const CorrConsts& cc) {
  constexpr int U = Plant::U;
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
  return r.finish(p, H) + corr;
}

}  // namespace ctt
