// The short rollout step of the ODE rollout kernels but the gradient ones: K1
// (cost_rollout.cu), K5 and K6 (cem_core.cuh), K2, K3's pass 1 and K4
// (mppi_ahead.cuh, through cem_core.cuh:column_steps) and K12's base step
// (residual_rollout.cu): the stage cost, then one control period of
// rollout_core.cuh's integrators in their operation order, with the
// plant's derivs_short (plants.cuh) in place of derivs: the plant's trig
// hook (Plant::sincos: sincosf, or fast_sincos for the fast plant) reduces
// theta once an evaluation, the stage cost shares the first evaluation's
// cos(theta) (the fast plant's cost takes its own cosf: the cost is
// exact), and the reciprocals of plants.cuh's Recips, taken once a
// rollout, leave one division an evaluation.  A plant without
// derivs_short (Plant::kShortStep false: pendulum, acrobot, point mass)
// takes Rollout::advance's stage cost and integrate instead, and its
// Recips is empty.  On an H100 this shortened
// K5's rk4 chain a step from ~1.7 µs to ~0.7 µs (PERF.md, K5); the chain
// of these dependent steps is what bounds each of those kernels.  K7 and
// K9 keep rollout_core.cuh's step for their forward sweeps.
#pragma once

#include "rollout_core.cuh"

namespace ctt {

// One rk4 sub-step (rollout_core.cuh substep's operation order) under
// derivs_short, from sin and cos of x's theta.
template <class Plant>
__device__ __forceinline__ void rk4_short(float (&x)[Plant::S], const float (&u)[Plant::U],
                                          float sin_t, float cos_t, const float* p,
                                          const typename Plant::Recips& rc,
                                          const StepConsts& c) {
  constexpr int S = Plant::S;
  float k1[S], k2[S], k3[S], k4[S], t[S], st, ct;
  Plant::derivs_short(x, u, sin_t, cos_t, p, rc, k1);
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = x[i] + c.half_dt * k1[i];
  Plant::sincos(t[2], st, ct);
  Plant::derivs_short(t, u, st, ct, p, rc, k2);
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = x[i] + c.half_dt * k2[i];
  Plant::sincos(t[2], st, ct);
  Plant::derivs_short(t, u, st, ct, p, rc, k3);
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = x[i] + c.sub_dt * k3[i];
  Plant::sincos(t[2], st, ct);
  Plant::derivs_short(t, u, st, ct, p, rc, k4);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float incr = (k1[i] + 2.0f * k2[i]) + (2.0f * k3[i] + k4[i]);
    x[i] = x[i] + c.dt6 * incr;
  }
}

// The stage cost of (x, u) against prev, then one control period
// (rollout_core.cuh Rollout::advance's function).
template <class Plant>
__device__ __forceinline__ void short_step(float (&x)[Plant::S], const float (&u)[Plant::U],
                                           float (&prev)[Plant::U], float& acc, const float* p,
                                           const typename Plant::Recips& rc, const StepConsts& c,
                                           float max_cost) {
  constexpr int S = Plant::S;
  if constexpr (!Plant::kShortStep) {
    // A plant without derivs_short (the pendulum, acrobot and point-mass
    // plants): Rollout::advance's stage cost and integrate, the JAX
    // operation order.
    acc = acc + Plant::stage_cost(x, u, prev, p, max_cost);
    integrate<Plant>(x, u, p, c);
  } else {
    float sin_t, cos_t;
    Plant::sincos(x[2], sin_t, cos_t);
    float cos_angle = cos_t;
    if constexpr (Plant::kFast) cos_angle = cosf(x[2]);  // the cost's exact cos
    acc = acc + Plant::stage_cost_cos(x, cos_angle, u, prev, p, max_cost);
    if (c.rk4 && c.substeps == 1) {  // the main path: one straight run
      rk4_short<Plant>(x, u, sin_t, cos_t, p, rc, c);
    } else {
      for (int sub = 0; sub < c.substeps; ++sub) {
        if (sub > 0) Plant::sincos(x[2], sin_t, cos_t);
        if (c.rk4) {
          rk4_short<Plant>(x, u, sin_t, cos_t, p, rc, c);
        } else {
          float k1[S];
          Plant::derivs_short(x, u, sin_t, cos_t, p, rc, k1);
#pragma unroll
          for (int i = 0; i < S; ++i) x[i] = x[i] + c.sub_dt * k1[i];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Plant::U; ++j) prev[j] = u[j];
}

}  // namespace ctt
