// The fully-fused CEM cost of one rollout, shared by K5 (fused_cem.cu, one
// session) and K6 (fused_cem_cols.cu, B sessions): the controls drawn in
// registers from the counter PRNG, clipped, rolled out and scored
// (control_toolkit_tpu/ops/pallas_cem.py, the bodies of build_fused_cem and
// build_fused_cem_cols).
//
// The control at step h and input j is
//   u = clamp(mue[h,j] + std[h,j] * z, low[j], high[j]),
//   z = counter_normal(base + j*jstride + h*hstride)
// in uint32 arithmetic; each kernel gives its own counter layout as
// (base, jstride, hstride).  mue + std*z is rounded twice, as torch and XLA
// compute it (no FMA contraction), so the rows that the torch regeneration
// draws again are the controls the kernel scored.  The rollout and cost are
// K1's (rollout_core.cuh Rollout).
#pragma once

#include "counter_prng.cuh"
#include "rollout_core.cuh"

namespace ctt {

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
      const float z = counter_normal(counter);
      const float v = __fadd_rn(__ldg(mue + h * U + j), __fmul_rn(__ldg(std_dev + h * U + j), z));
      u[j] = fminf(fmaxf(v, lo[j]), hi[j]);
    }
    r.advance(u, p, c, max_cost);
  }
  return r.finish(p, H);
}

}  // namespace ctt
