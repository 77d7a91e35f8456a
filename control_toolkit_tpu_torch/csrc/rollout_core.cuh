// The rollout core shared by every rollout kernel: one thread owns one
// rollout and keeps its state, previous control and cost sum in registers
// for all H steps.  It replaces the TPU kernels' shared body
// (control_toolkit_tpu/ops/pallas_mppi.py:rollout_cost_core with
// ops/soa_integrators.py:make_soa_stepper), which held the same values as
// [8, C] vector tiles in VMEM.
#pragma once

#include <cuda_runtime.h>

#include "plants.cuh"

namespace ctt {

// Integrator constants.  The host computes them in double and rounds them
// to float, as the Python floats of soa_integrators.py are rounded when
// they meet a float32 tensor.
struct StepConsts {
  int rk4;        // 1: rk4, 0: euler
  int substeps;   // intermediate_steps
  float sub_dt;   // dt / substeps
  float half_dt;  // 0.5 * sub_dt
  float dt6;      // sub_dt / 6
};

// One euler or rk4 sub-step of soa_integrators.py, in its operation order
// (rk4: (k1 + 2*k2) + (2*k3 + k4)).
template <class Plant>
__device__ __forceinline__ void substep(float (&x)[Plant::S], const float (&u)[Plant::U],
                                        const float* p, const StepConsts& c) {
  constexpr int S = Plant::S;
  float k1[S];
  Plant::derivs(x, u, p, k1);
  if (!c.rk4) {
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + c.sub_dt * k1[i];
    return;
  }
  float t[S], k2[S], k3[S], k4[S];
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = x[i] + c.half_dt * k1[i];
  Plant::derivs(t, u, p, k2);
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = x[i] + c.half_dt * k2[i];
  Plant::derivs(t, u, p, k3);
#pragma unroll
  for (int i = 0; i < S; ++i) t[i] = x[i] + c.sub_dt * k3[i];
  Plant::derivs(t, u, p, k4);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float incr = (k1[i] + 2.0f * k2[i]) + (2.0f * k3[i] + k4[i]);
    x[i] = x[i] + c.dt6 * incr;
  }
}

// Advance x by one control period: `substeps` sub-steps.
template <class Plant>
__device__ __forceinline__ void integrate(float (&x)[Plant::S], const float (&u)[Plant::U],
                                          const float* p, const StepConsts& c) {
  for (int sub = 0; sub < c.substeps; ++sub) substep<Plant>(x, u, p, c);
}

// The transposed sub-step at its start state x (ops/adjoints.py _euler_vjp
// and _rk4_vjp): lam, the cotangent of the sub-step's end state, becomes
// that of x; du receives the control's part.
template <class Plant>
__device__ __forceinline__ void substep_vjp(const float (&x)[Plant::S], const float (&u)[Plant::U],
                                            const float* p, const StepConsts& c,
                                            float (&lam)[Plant::S], float (&du)[Plant::U]) {
  constexpr int S = Plant::S, U = Plant::U;
  float g[S], a[S], b[U];
  if (!c.rk4) {
#pragma unroll
    for (int i = 0; i < S; ++i) g[i] = c.sub_dt * lam[i];
    Plant::derivs_vjp(x, u, p, g, a, du);
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = lam[i] + a[i];
    return;
  }
  // The rk4 stage states t2, t3, t4, recomputed.
  float k[S], t2[S], t3[S], t4[S];
  Plant::derivs(x, u, p, k);
#pragma unroll
  for (int i = 0; i < S; ++i) t2[i] = x[i] + c.half_dt * k[i];
  Plant::derivs(t2, u, p, k);
#pragma unroll
  for (int i = 0; i < S; ++i) t3[i] = x[i] + c.half_dt * k[i];
  Plant::derivs(t3, u, p, k);
#pragma unroll
  for (int i = 0; i < S; ++i) t4[i] = x[i] + c.sub_dt * k[i];
  // x' = x + dt6 * ((k1 + 2*k2) + (2*k3 + k4)), transposed last to first;
  // lam accumulates ((((lam + a4) + a3) + a2) + a1), du ((b4 + b3) + b2) + b1.
  float gi[S];
#pragma unroll
  for (int i = 0; i < S; ++i) gi[i] = c.dt6 * lam[i];
  Plant::derivs_vjp(t4, u, p, gi, a, du);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    lam[i] = lam[i] + a[i];
    g[i] = 2.0f * gi[i] + c.sub_dt * a[i];
  }
  Plant::derivs_vjp(t3, u, p, g, a, b);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    lam[i] = lam[i] + a[i];
    g[i] = 2.0f * gi[i] + c.half_dt * a[i];
  }
#pragma unroll
  for (int j = 0; j < U; ++j) du[j] = du[j] + b[j];
  Plant::derivs_vjp(t2, u, p, g, a, b);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    lam[i] = lam[i] + a[i];
    g[i] = gi[i] + c.half_dt * a[i];
  }
#pragma unroll
  for (int j = 0; j < U; ++j) du[j] = du[j] + b[j];
  Plant::derivs_vjp(x, u, p, g, a, b);
#pragma unroll
  for (int i = 0; i < S; ++i) lam[i] = lam[i] + a[i];
#pragma unroll
  for (int j = 0; j < U; ++j) du[j] = du[j] + b[j];
}

// The transposed control period (ops/adjoints.py integrator_vjp): from the
// period's start state x, each sub-step's start state is re-integrated,
// last sub-step first (no per-sub-step storage, so `substeps` stays a
// runtime value); lam becomes x's cotangent and du sums the control's parts.
template <class Plant>
__device__ __forceinline__ void integrate_vjp(const float (&x)[Plant::S],
                                              const float (&u)[Plant::U], const float* p,
                                              const StepConsts& c, float (&lam)[Plant::S],
                                              float (&du)[Plant::U]) {
  constexpr int S = Plant::S, U = Plant::U;
#pragma unroll
  for (int j = 0; j < U; ++j) du[j] = 0.0f;
  for (int sub = c.substeps - 1; sub >= 0; --sub) {
    float xs[S], b[U];
#pragma unroll
    for (int i = 0; i < S; ++i) xs[i] = x[i];
    for (int r = 0; r < sub; ++r) substep<Plant>(xs, u, p, c);
    substep_vjp<Plant>(xs, u, p, c, lam, b);
#pragma unroll
    for (int j = 0; j < U; ++j) du[j] = du[j] + b[j];
  }
}

// y = T + c dk over a tangent.
template <class Plant>
__device__ __forceinline__ void tangent_axpy(const float (&T)[Plant::S][Plant::S + Plant::U],
                                             float c,
                                             const float (&dk)[Plant::S][Plant::S + Plant::U],
                                             float (&y)[Plant::S][Plant::S + Plant::U]) {
#pragma unroll
  for (int i = 0; i < Plant::S; ++i) {
#pragma unroll
    for (int n = 0; n < Plant::S + Plant::U; ++n) y[i][n] = T[i][n] + c * dk[i][n];
  }
}

// The control period's Jacobians in forward mode (ops/adjoints.py
// integrator_jac): x advances by one period as integrate does (from the
// plant's derivs_tangent values) and T, which enters as [I | 0], leaves as
// d x' / d(x, u) = [A | B].  Each stage carries the tangent of its state,
// T + c dk of the stage before, through the plant's Jacobian (its
// derivs_tangent: J (T; E), the control's rows E = [0 | I]); the period's
// tangent sums the stages' in the state's order
// ((dk1 + 2 dk2) + (2 dk3 + dk4)).
template <class Plant>
__device__ __forceinline__ void integrate_jac(float (&x)[Plant::S], const float (&u)[Plant::U],
                                              const float* p, const StepConsts& c,
                                              float (&T)[Plant::S][Plant::S + Plant::U]) {
  constexpr int S = Plant::S, N = Plant::S + Plant::U;
  for (int sub = 0; sub < c.substeps; ++sub) {
    float k[S], dk[S][N];
    Plant::derivs_tangent(x, u, p, T, k, dk);
    if (!c.rk4) {
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = x[i] + c.sub_dt * k[i];
      tangent_axpy<Plant>(T, c.sub_dt, dk, T);
      continue;
    }
    // incr = (k1 + 2 k2) + (2 k3 + k4), and its tangent alike.
    float incr[S], dincr[S][N], t[S], Tt[S][N];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      incr[i] = k[i];
      t[i] = x[i] + c.half_dt * k[i];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int n = 0; n < N; ++n) dincr[i][n] = dk[i][n];
    }
    tangent_axpy<Plant>(T, c.half_dt, dk, Tt);
    Plant::derivs_tangent(t, u, p, Tt, k, dk);  // k2
#pragma unroll
    for (int i = 0; i < S; ++i) {
      incr[i] = incr[i] + 2.0f * k[i];
      t[i] = x[i] + c.half_dt * k[i];
#pragma unroll
      for (int n = 0; n < N; ++n) dincr[i][n] = dincr[i][n] + 2.0f * dk[i][n];
    }
    tangent_axpy<Plant>(T, c.half_dt, dk, Tt);
    Plant::derivs_tangent(t, u, p, Tt, k, dk);  // k3
    float k3[S], dk3[S][N];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      k3[i] = k[i];
      t[i] = x[i] + c.sub_dt * k[i];
#pragma unroll
      for (int n = 0; n < N; ++n) dk3[i][n] = dk[i][n];
    }
    tangent_axpy<Plant>(T, c.sub_dt, dk, Tt);
    Plant::derivs_tangent(t, u, p, Tt, k, dk);  // k4
#pragma unroll
    for (int i = 0; i < S; ++i) {
      x[i] = x[i] + c.dt6 * (incr[i] + (2.0f * k3[i] + k[i]));
#pragma unroll
      for (int n = 0; n < N; ++n) {
        T[i][n] = T[i][n] + c.dt6 * (dincr[i][n] + (2.0f * dk3[i][n] + dk[i][n]));
      }
    }
  }
}

// One rollout's registers: state, previous control, stage-cost sum.
template <class Plant>
struct Rollout {
  float x[Plant::S];
  float prev[Plant::U];
  float acc;

  // Start from s0 with the applied previous control from the packed params.
  __device__ __forceinline__ void start(const float* s0, const float* p) {
#pragma unroll
    for (int i = 0; i < Plant::S; ++i) x[i] = s0[i];
#pragma unroll
    for (int j = 0; j < Plant::U; ++j) prev[j] = p[Plant::kUPrev + j];
    acc = 0.0f;
  }

  // Stage cost of (x, u) against the previous control, then step.
  __device__ __forceinline__ void advance(const float (&u)[Plant::U], const float* p,
                                          const StepConsts& c, float max_cost) {
    acc = acc + Plant::stage_cost(x, u, prev, p, max_cost);
    integrate<Plant>(x, u, p, c);
#pragma unroll
    for (int j = 0; j < Plant::U; ++j) prev[j] = u[j];
  }

  // Trajectory cost: the mean over H stage costs and the terminal cost.
  __device__ __forceinline__ float finish(const float* p, int H) const {
    return (acc + Plant::terminal_cost(x, p)) / static_cast<float>(H + 1);
  }
};

// The packed parameters, copied into registers once per thread.
template <class Plant>
__device__ __forceinline__ void load_params(const float* __restrict__ pvec, float (&p)[Plant::kN]) {
#pragma unroll
  for (int i = 0; i < Plant::kN; ++i) p[i] = __ldg(pvec + i);
}

constexpr int kPlantCartpole = 0;      // ops/kernels.py PLANT_IDS: CartpolePlant
constexpr int kPlantCartpoleFast = 1;  // CartpoleFastPlant (the ":fast" predictors')
constexpr int kPlantPendulum = 2;      // PendulumPlant
constexpr int kPlantPendulumFast = 3;  // PendulumFastPlant
constexpr int kPlantAcrobot = 4;       // AcrobotPlant
constexpr int kPlantAcrobotFast = 5;   // AcrobotFastPlant
constexpr int kPlantPointmass = 6;     // PointmassPlant
constexpr int kPlantPointmassObstacles = 7;  // PointmassObstaclePlant
constexpr int kThreads = 128;      // rollouts per block

// f(Plant{}) for the plant of id `plant` among the pendulum, acrobot and
// point-mass plants, which K1, K2, K3 and K7 carry in their plain entries
// alone (ops/kernels.py KERNEL_PLANTS); cudaErrorInvalidValue for any
// other id.  Host code: the entries' switches call it for every id but
// cartpole's.
inline bool is_slice_plant(int plant) {
  return plant >= kPlantPendulum && plant <= kPlantPointmassObstacles;
}

template <class F>
int with_slice_plant(int plant, F&& f) {
  switch (plant) {
    case kPlantPendulum:
      return f(PendulumPlant{});
    case kPlantPendulumFast:
      return f(PendulumFastPlant{});
    case kPlantAcrobot:
      return f(AcrobotPlant{});
    case kPlantAcrobotFast:
      return f(AcrobotFastPlant{});
    case kPlantPointmass:
      return f(PointmassPlant{});
    case kPlantPointmassObstacles:
      return f(PointmassObstaclePlant{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ctt
