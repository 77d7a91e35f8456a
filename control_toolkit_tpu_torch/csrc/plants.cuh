// Device plants: a model's dynamics and its cost's per-step terms, for the
// rollout core (rollout_core.cuh).
//
// A plant reads every scalar from the packed parameter vector `p`, laid out
// in Optimizer._soa_bindings' order for its (dynamics, cost) pair: d_* keys
// sorted, c_* keys sorted, a_* keys sorted, then __u_prev_j.  The Python
// side (ops/kernels.py PLANT_PARAM_KEYS) checks that order before any
// launch, so a changed weight, target or dynamics constant is a new value
// in `p`, never a rebuild.
//
// Each expression copies the operation order of its Python counterpart
// (models/dynamics.py, costs/cartpole.py).  sinf/cosf are the accurate
// library functions, not the __sinf/__cosf intrinsics.
#pragma once

namespace ctt {

// Cart-pole dynamics (models/dynamics.py:_cartpole_derivs) with the
// cartpole/default cost (costs/cartpole.py:CartpoleQuadraticCost).
struct CartpolePlant {
  static constexpr int S = 4;  // position, positionD, angle, angleD
  static constexpr int U = 1;  // force command in [-1, 1]
  enum : int {
    kL = 0, kFrictionCart, kFrictionPole, kG, kMCart, kMPole, kUMax,
    kR, kCcWeight, kCcrcWeight, kDdWeight, kEkpWeight, kEpWeight,
    kTargetPosition,
    kUPrev,  // __u_prev_0 .. __u_prev_{U-1}
    kN = kUPrev + U
  };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float pos_d = x[1], theta = x[2], theta_d = x[3];
    const float force = u[0] * p[kUMax];
    const float m_c = p[kMCart], m_p = p[kMPole], L = p[kL], g = p[kG];
    const float sin_t = sinf(theta), cos_t = cosf(theta);
    const float total_m = m_c + m_p;
    const float temp =
        (force + m_p * L * (theta_d * theta_d) * sin_t - p[kFrictionCart] * pos_d) / total_m;
    const float theta_dd =
        (g * sin_t - cos_t * temp - p[kFrictionPole] * theta_d / (m_p * L)) /
        (L * (4.0f / 3.0f - m_p * (cos_t * cos_t) / total_m));
    const float pos_dd = temp - m_p * L * theta_dd * cos_t / total_m;
    d[0] = pos_d;
    d[1] = pos_dd;
    d[2] = theta_d;
    d[3] = theta_dd;
  }

  // Stage cost with the control-change term and the MAX_COST shift
  // (Optimizer._soa_bindings stage_soa).
  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* p,
                                                     float max_cost) {
    const float pos = x[0], angle = x[2], angle_d = x[3];
    const float dpos = pos - p[kTargetPosition];
    const float dd = p[kDdWeight] * (dpos * dpos);
    const float omc = 1.0f - cosf(angle);
    const float ep = p[kEpWeight] * 0.25f * (omc * omc);
    const float ad = angle_d / 6.283185307179586f;  // 2*pi rounded to float
    const float ekp = p[kEkpWeight] * (ad * ad);
    float usq = 0.0f, dusq = 0.0f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      usq = usq + u[j] * u[j];
      const float du = u[j] - prev[j];
      dusq = dusq + du * du;
    }
    const float cc = p[kCcWeight] * p[kR] * usq;
    const float core = dd + ep + ekp + cc;
    return (core + p[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* p) {
    const float angle = x[2], angle_d = x[3];
    const float omc = 1.0f - cosf(angle);
    return 1.0e4f * (omc * omc) + 10.0f * (angle_d * angle_d);
  }
};

}  // namespace ctt
