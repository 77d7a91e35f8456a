// The fully-fused CEM control of one counter, shared by K5 (fused_cem.cu,
// one session) and K6 (fused_cem_cols.cu, B sessions), and K6's cost of
// one rollout: the controls drawn in registers from the counter PRNG,
// clipped, rolled out and scored (control_toolkit_tpu/ops/pallas_cem.py,
// the bodies of build_fused_cem and build_fused_cem_cols).  K5 draws a
// rollout's controls ahead of its steps and integrates with its own plant
// form (fused_cem.cu).
//
// The control at step h and input j is
//   u = clamp(mue[h,j] + std[h,j] * z, low[j], high[j]),
//   z = counter_normal(base + j*jstride + h*hstride)
// in uint32 arithmetic; each kernel gives its own counter layout as
// (base, jstride, hstride).  mue + std*z is rounded twice, as torch and XLA
// compute it (no FMA contraction), so the rows that the torch regeneration
// draws again are the controls the kernel scored.  K6's rollout and cost
// are K1's (rollout_core.cuh Rollout).
#pragma once

#include "counter_prng.cuh"
#include "rollout_core.cuh"

namespace ctt {

// The clipped control of one counter: clamp(mue + std * z, lo, hi), the
// sum and the product each rounded (no FMA contraction).
__device__ __forceinline__ float cem_control(uint32_t counter, float mue, float std_dev, float lo,
                                             float hi) {
  const float v = __fadd_rn(mue, __fmul_rn(std_dev, counter_normal(counter)));
  return fminf(fmaxf(v, lo), hi);
}

template <class Plant>
__device__ __forceinline__ float cem_rollout_cost(const float* __restrict__ s0,
                                                  const float* __restrict__ mue,
                                                  const float* __restrict__ std_dev,
                                                  const float (&p)[Plant::kN],
                                                  const float (&lo)[Plant::U],
                                                  const float (&hi)[Plant::U], uint32_t base,
                                                  uint32_t jstride, uint32_t hstride, int H,
                                                  const StepConsts& c, float max_cost) {
  constexpr int U = Plant::U;
  Rollout<Plant> r;
  r.start(s0, p);
  for (int h = 0; h < H; ++h) {
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const uint32_t counter =
          base + static_cast<uint32_t>(j) * jstride + static_cast<uint32_t>(h) * hstride;
      u[j] = cem_control(counter, __ldg(mue + h * U + j), __ldg(std_dev + h * U + j), lo[j],
                         hi[j]);
    }
    r.advance(u, p, c, max_cost);
  }
  return r.finish(p, H);
}

}  // namespace ctt
