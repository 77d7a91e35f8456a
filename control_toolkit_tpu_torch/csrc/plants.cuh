// Device plants: a model's dynamics and its cost's per-step terms, for the
// rollout kernels (rollout_core.cuh and the kernels over it).
//
// A plant reads every scalar from the packed parameter vector `p`, laid out
// in Optimizer._soa_bindings' order for its (dynamics, cost) pair: d_* keys
// sorted, c_* keys sorted, a_* keys sorted, then __u_prev_j.  The cost part
// is a struct of its own that reads from its own base pointer: the ODE
// kernels pass it p + Dynamics::kN, the network-rollout kernels (whose
// dynamics are weight tensors, not packed scalars) pass p itself.  The
// Python side (ops/kernels.py DYN_PARAM_KEYS, COST_PARAM_KEYS) checks both
// layouts before any launch, so a changed weight, target or dynamics
// constant is a new value in `p`, never a rebuild.
//
// Each expression copies the operation order of its Python counterpart
// (models/dynamics.py, costs/cartpole.py).  sinf/cosf are the accurate
// library functions, not the __sinf/__cosf intrinsics.
//
// The cartpole plant comes in two instances of one template on its trig:
// CartpolePlant (exact, sinf/cosf/sincosf) and CartpoleFastPlant (the
// ":fast" predictors' plant, models/dynamics.py cartpole_derivs_soa_fast:
// fastmath.cuh's fast_sincos in every plant evaluation, and in its
// adjoints the polynomials' derivatives, fast_sincos_d, as jax.vjp takes
// them).  Each trig site is an `if constexpr`, so the exact instance
// compiles to the code it had before the template.  The cost stays exact
// in both: the JAX cartpole cost calls jnp.cos whatever the plant, so
// the fast instance's short step (short_step.cuh) takes the stage cost's
// cos(angle) from its own cosf.  Plant::sincos is the hook short_step.cuh
// calls in place of sincosf; Plant::kFast also picks the fast counter
// normals (counter_prng.cuh) in the fully-fused kernels.
//
// A plant is a (dynamics, cost) pair.  Besides cartpole's there are the
// pendulum (PendulumDynamicsT<Fast>, S=2), the acrobot
// (AcrobotDynamicsT<Fast>: two angles, sin(t1+t2)) and the point mass
// (PointmassDynamics: U=2, no trig), under the pendulum/default,
// acrobot/default, pointmass/default and pointmass/obstacles costs
// (PendulumCost, AcrobotCost, PointmassCost, PointmassObstacleCost), bound
// by PlantT.  Their plants have no derivs_short (kShortStep false): the
// short step takes Plant::stage_cost and rollout_core.cuh's integrate, the
// JAX operation order with no hand algebra, and Recips is empty.  Their
// derivs_vjp and derivs_tangent are their Jacobians' nontrivial rows
// (ops/adjoints.py *_derivs_jac, transcribed), the other rows being the
// velocities' unit rows; their costs stay exact under a fast plant (the
// JAX costs call jnp.cos whatever the plant).  The point mass has no trig,
// so its exact dynamics double as the fast ones (kExactIsFast): only K3
// takes a fast-normals instance of it (FastNormalsOf), which draws the
// fast counter normals over the exact plant.
#pragma once

#include "fastmath.cuh"

namespace ctt {

// Cart-pole dynamics (models/dynamics.py:_cartpole_derivs) over exact
// (Fast false) or polynomial trig.
template <bool Fast>
struct CartpoleDynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr int S = 4;  // position, positionD, angle, angleD
  static constexpr int U = 1;  // force command in [-1, 1]
  enum : int { kL = 0, kFrictionCart, kFrictionPole, kG, kMCart, kMPole, kUMax, kN };

  // sin and cos of theta, once: the short step's trig (short_step.cuh).
  __device__ __forceinline__ static void sincos(float theta, float& sin_t, float& cos_t) {
    if constexpr (Fast) {
      fast_sincos(theta, sin_t, cos_t);
    } else {
      sincosf(theta, &sin_t, &cos_t);
    }
  }

  // sin and cos of theta, and the derivatives the adjoints take: dsin =
  // d sin / d theta and ndcos = -d cos / d theta, exact trig's cos and sin.
  __device__ __forceinline__ static void sincos_d(float theta, float& sin_t, float& cos_t,
                                                  float& dsin, float& ndcos) {
    if constexpr (Fast) {
      fast_sincos_d(theta, sin_t, cos_t, dsin, ndcos);
    } else {
      sin_t = sinf(theta);
      cos_t = cosf(theta);
      dsin = cos_t;
      ndcos = sin_t;
    }
  }

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float pos_d = x[1], theta = x[2], theta_d = x[3];
    const float force = u[0] * p[kUMax];
    const float m_c = p[kMCart], m_p = p[kMPole], L = p[kL], g = p[kG];
    float sin_t, cos_t;
    if constexpr (Fast) {
      fast_sincos(theta, sin_t, cos_t);
    } else {
      sin_t = sinf(theta);
      cos_t = cosf(theta);
    }
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

  // K5's form of derivs (fused_cem.cu): d = f(x, u) from sin and cos of
  // theta, taken once by the caller (sincos), and the reciprocals of
  // Recips, taken once a rollout, in place of four of derivs' five
  // divisions; one division, num / den, stays.  The operation order is
  // derivs_tangent's.
  struct Recips {
    float inv_m, inv_mpl;  // 1 / (m_cart + m_pole), 1 / (m_pole L)
  };
  __device__ __forceinline__ static Recips recips(const float* p) {
    return {1.0f / (p[kMCart] + p[kMPole]), 1.0f / (p[kMPole] * p[kL])};
  }
  __device__ __forceinline__ static void derivs_short(const float (&x)[S], const float (&u)[U],
                                                      float sin_t, float cos_t, const float* p,
                                                      const Recips& r, float (&d)[S]) {
    const float pos_d = x[1], theta_d = x[3];
    const float force = u[0] * p[kUMax];
    const float m_p = p[kMPole], L = p[kL];
    const float mpl = m_p * L;
    const float temp =
        (force + mpl * (theta_d * theta_d) * sin_t - p[kFrictionCart] * pos_d) * r.inv_m;
    const float num = p[kG] * sin_t - cos_t * temp - p[kFrictionPole] * theta_d * r.inv_mpl;
    const float den = L * (4.0f / 3.0f - m_p * (cos_t * cos_t) * r.inv_m);
    const float theta_dd = num / den;
    d[0] = pos_d;
    d[1] = temp - mpl * theta_dd * cos_t * r.inv_m;
    d[2] = theta_d;
    d[3] = theta_dd;
  }

  // The adjoint (ops/adjoints.py, transcribed term for term):
  // dx = lam^T df/dx, du = lam^T df/du at (x, u): cartpole_derivs_vjp.
  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    const float pos_d = x[1], theta = x[2], theta_d = x[3];
    const float m_p = p[kMPole], L = p[kL], g = p[kG];
    const float fc = p[kFrictionCart], fp = p[kFrictionPole];
    const float force = u[0] * p[kUMax];
    float sin_t, cos_t, dsin, ndcos;
    sincos_d(theta, sin_t, cos_t, dsin, ndcos);
    const float total_m = p[kMCart] + m_p;
    const float mpl = m_p * L;
    const float temp = (force + mpl * (theta_d * theta_d) * sin_t - fc * pos_d) / total_m;
    const float num = g * sin_t - cos_t * temp - fp * theta_d / mpl;
    const float den = L * (4.0f / 3.0f - m_p * (cos_t * cos_t) / total_m);
    const float theta_dd = num / den;
    // pos_dd = temp - mpl * theta_dd * cos_t / total_m
    float g_temp = lam[1];
    const float g_thdd = lam[3] - lam[1] * mpl * cos_t / total_m;
    float g_cos = -(lam[1] * mpl * theta_dd / total_m);
    // theta_dd = num / den
    const float g_num = g_thdd / den;
    const float g_den = -(g_thdd * theta_dd / den);
    // den = L * (4/3 - m_p * cos^2 / total_m)
    g_cos = g_cos - g_den * L * m_p * 2.0f * cos_t / total_m;
    // num = g * sin - cos * temp - fp * theta_d / mpl
    float g_sin = g_num * g;
    g_cos = g_cos - g_num * temp;
    g_temp = g_temp - g_num * cos_t;
    float g_thd = lam[2] - g_num * fp / mpl;
    // temp = (force + mpl * theta_d^2 * sin - fc * pos_d) / total_m
    const float g_a = g_temp / total_m;
    g_thd = g_thd + g_a * mpl * 2.0f * theta_d * sin_t;
    g_sin = g_sin + g_a * mpl * (theta_d * theta_d);
    dx[0] = 0.0f;
    dx[1] = lam[0] - g_a * fc;
    dx[2] = g_sin * dsin - g_cos * ndcos;
    dx[3] = g_thd;
    du[0] = g_a * p[kUMax];
  }

  // The Jacobian's product with a tangent (ops/adjoints.py
  // cartpole_derivs_jac, transcribed term for term): d = f(x, u), and
  // dk = J (T; E) for the tangent T [S][N] of (x) and E [U][N] = [0 | I]
  // of u (N = S + U), J = d f / d(x, u).  Rows 0 and 2 of J are the unit
  // rows of pos_d and theta_d, and no row depends on pos, so only rows 1
  // and 3 are multiplied out; the three reciprocals replace the
  // divisions of derivs, and sincosf reduces theta once (the fast
  // instance: fast_sincos_d, with the polynomials' derivatives).
  template <int N>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    const float pos_d = x[1], theta = x[2], theta_d = x[3];
    const float m_p = p[kMPole], L = p[kL], g = p[kG];
    const float fc = p[kFrictionCart], fp = p[kFrictionPole];
    const float force = u[0] * p[kUMax];
    float sin_t, cos_t, dsin, ndcos;
    if constexpr (Fast) {
      fast_sincos_d(theta, sin_t, cos_t, dsin, ndcos);
    } else {
      sincosf(theta, &sin_t, &cos_t);
      dsin = cos_t;
      ndcos = sin_t;
    }
    const float mpl = m_p * L;
    const float inv_m = 1.0f / (p[kMCart] + m_p), inv_mpl = 1.0f / mpl;
    const float temp = (force + mpl * (theta_d * theta_d) * sin_t - fc * pos_d) * inv_m;
    const float num = g * sin_t - cos_t * temp - fp * theta_d * inv_mpl;
    const float inv_den = 1.0f / (L * (4.0f / 3.0f - m_p * (cos_t * cos_t) * inv_m));
    const float theta_dd = num * inv_den;
    d[0] = pos_d;
    d[1] = temp - mpl * theta_dd * cos_t * inv_m;
    d[2] = theta_d;
    d[3] = theta_dd;
    // temp's partials in pos_d, theta, theta_d and u
    const float t1 = -fc * inv_m;
    const float t2 = mpl * (theta_d * theta_d) * dsin * inv_m;
    const float t3 = mpl * 2.0f * theta_d * sin_t * inv_m;
    const float tu = p[kUMax] * inv_m;
    // num's, and den's in theta
    const float n1 = -(cos_t * t1);
    const float n2 = g * dsin + ndcos * temp - cos_t * t2;
    const float n3 = -(cos_t * t3) - fp * inv_mpl;
    const float nu = -(cos_t * tu);
    const float d2 = L * (m_p * 2.0f * cos_t * ndcos * inv_m);
    // theta_dd = num / den
    const float a1 = n1 * inv_den, a2 = (n2 - theta_dd * d2) * inv_den;
    const float a3 = n3 * inv_den, au = nu * inv_den;
    // pos_dd = temp - mpl * theta_dd * cos_t / total_m
    const float c = mpl * inv_m;
    const float b1 = t1 - c * (a1 * cos_t);
    const float b2 = t2 - c * (a2 * cos_t - theta_dd * ndcos);
    const float b3 = t3 - c * (a3 * cos_t);
    const float bu = tu - c * (au * cos_t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dk[0][n] = T[1][n];
      dk[2][n] = T[3][n];
      dk[1][n] = fmaf(b3, T[3][n], fmaf(b2, T[2][n], fmaf(b1, T[1][n], n == S ? bu : 0.0f)));
      dk[3][n] = fmaf(a3, T[3][n], fmaf(a2, T[2][n], fmaf(a1, T[1][n], n == S ? au : 0.0f)));
    }
  }
};

// The cartpole/default cost (costs/cartpole.py:CartpoleQuadraticCost) over
// its own packed vector `c`: the cost weights, the target, __u_prev.
struct CartpoleCost {
  static constexpr int S = 4;
  static constexpr int U = 1;
  enum : int {
    kR = 0, kCcWeight, kCcrcWeight, kDdWeight, kEkpWeight, kEpWeight,
    kTargetPosition,
    kUPrev,  // __u_prev_0 .. __u_prev_{U-1}
    kN = kUPrev + U
  };

  // Stage cost with the control-change term and the MAX_COST shift
  // (Optimizer._soa_bindings stage_soa).
  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    return stage_cost_cos(x, cosf(x[2]), u, prev, c, max_cost);
  }

  // The same from cos_angle = cos(x[2]), which the caller may share (K5's
  // step takes it from the sincosf of its first plant evaluation).
  __device__ __forceinline__ static float stage_cost_cos(const float (&x)[S], float cos_angle,
                                                         const float (&u)[U],
                                                         const float (&prev)[U], const float* c,
                                                         float max_cost) {
    const float pos = x[0], angle_d = x[3];
    const float dpos = pos - c[kTargetPosition];
    const float dd = c[kDdWeight] * (dpos * dpos);
    const float omc = 1.0f - cos_angle;
    const float ep = c[kEpWeight] * 0.25f * (omc * omc);
    const float ad = angle_d / 6.283185307179586f;  // 2*pi rounded to float
    const float ekp = c[kEkpWeight] * (ad * ad);
    float usq = 0.0f, dusq = 0.0f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      usq = usq + u[j] * u[j];
      const float du = u[j] - prev[j];
      dusq = dusq + du * du;
    }
    const float cc = c[kCcWeight] * c[kR] * usq;
    const float core = dd + ep + ekp + cc;
    return (core + c[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    const float angle = x[2], angle_d = x[3];
    const float omc = 1.0f - cosf(angle);
    return 1.0e4f * (omc * omc) + 10.0f * (angle_d * angle_d);
  }

  // The adjoints (ops/adjoints.py, transcribed term for term).

  // Gradient of ct * stage_cost: cartpole_stage_vjp.  gprev is u's part in
  // the next stage's control-change term, -2 * ccrc * (u - prev) * ct.
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    const float pos = x[0], angle = x[2], angle_d = x[3];
    const float two_pi = 6.283185307179586f;
    gx[0] = ct * (2.0f * c[kDdWeight]) * (pos - c[kTargetPosition]);
    gx[1] = 0.0f;
    gx[2] = ct * (0.5f * c[kEpWeight]) * (1.0f - cosf(angle)) * sinf(angle);
    gx[3] = ct * (2.0f * c[kEkpWeight]) * (angle_d / two_pi) / two_pi;
    const float cc = 2.0f * c[kCcWeight] * c[kR];
    const float ccrc = 2.0f * c[kCcrcWeight];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float dchange = ct * ccrc * (u[j] - prev[j]);
      gu[j] = ct * cc * u[j] + dchange;
      gprev[j] = -dchange;
    }
  }

  // Gradient of ct * terminal_cost: cartpole_terminal_grad.
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    const float angle = x[2], angle_d = x[3];
    g[0] = 0.0f;
    g[1] = 0.0f;
    g[2] = ct * 2.0e4f * (1.0f - cosf(angle)) * sinf(angle);
    g[3] = ct * 20.0f * angle_d;
  }
};

// The ODE kernels' plant: the dynamics' constants, then the cost's vector.
template <bool Fast>
struct CartpolePlantT {
  using Dynamics = CartpoleDynamicsT<Fast>;
  using Cost = CartpoleCost;
  static constexpr bool kFast = Fast;
  static constexpr bool kShortStep = true;  // derivs_short (short_step.cuh)
  static constexpr bool kExactIsFast = false;
  static constexpr int S = Dynamics::S;
  static constexpr int U = Dynamics::U;
  static constexpr int kCost = Dynamics::kN;  // the cost part's base
  static constexpr int kUPrev = kCost + Cost::kUPrev;
  static constexpr int kN = kCost + Cost::kN;

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    Dynamics::derivs(x, u, p, d);
  }
  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    Dynamics::derivs_vjp(x, u, p, lam, dx, du);
  }
  template <int N>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    Dynamics::derivs_tangent(x, u, p, T, d, dk);
  }
  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* p,
                                                     float max_cost) {
    return Cost::stage_cost(x, u, prev, p + kCost, max_cost);
  }
  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* p) {
    return Cost::terminal_cost(x, p + kCost);
  }
  using Recips = typename Dynamics::Recips;
  __device__ __forceinline__ static Recips recips(const float* p) { return Dynamics::recips(p); }
  __device__ __forceinline__ static void sincos(float theta, float& sin_t, float& cos_t) {
    Dynamics::sincos(theta, sin_t, cos_t);
  }
  __device__ __forceinline__ static void derivs_short(const float (&x)[S], const float (&u)[U],
                                                      float sin_t, float cos_t, const float* p,
                                                      const Recips& r, float (&d)[S]) {
    Dynamics::derivs_short(x, u, sin_t, cos_t, p, r, d);
  }
  __device__ __forceinline__ static float stage_cost_cos(const float (&x)[S], float cos_angle,
                                                         const float (&u)[U],
                                                         const float (&prev)[U], const float* p,
                                                         float max_cost) {
    return Cost::stage_cost_cos(x, cos_angle, u, prev, p + kCost, max_cost);
  }
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* p,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    Cost::stage_cost_vjp(x, u, prev, p + kCost, ct, gx, gu, gprev);
  }
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* p,
                                                            float ct, float (&g)[S]) {
    Cost::terminal_cost_grad(x, p + kCost, ct, g);
  }
};

// The two instances, named as the kernels' template arguments (their
// entries' mangled names): rollout_core.cuh kPlantCartpole and
// kPlantCartpoleFast select them.
struct CartpolePlant : CartpolePlantT<false> {};
struct CartpoleFastPlant : CartpolePlantT<true> {};

// sin of a, and its derivative as the adjoints take it: exact trig's cos,
// or the polynomial's S'(r) (fast_sincos_d).
template <bool Fast>
__device__ __forceinline__ float plant_sin(float a) {
  if constexpr (Fast) {
    return fast_sin(a);
  } else {
    return sinf(a);
  }
}
template <bool Fast>
__device__ __forceinline__ void plant_sin_d(float a, float& s, float& ds) {
  if constexpr (Fast) {
    float c, ndc;
    fast_sincos_d(a, s, c, ds, ndc);
  } else {
    s = sinf(a);
    ds = cosf(a);
  }
}
// sin and cos of a, and the derivatives: dsin and ndcos = -d cos / d a.
template <bool Fast>
__device__ __forceinline__ void plant_sincos_d(float a, float& s, float& c, float& ds,
                                               float& ndc) {
  if constexpr (Fast) {
    fast_sincos_d(a, s, c, ds, ndc);
  } else {
    s = sinf(a);
    c = cosf(a);
    ds = c;
    ndc = s;
  }
}

// Pendulum dynamics (models/dynamics.py:_pendulum_derivs): angle 0 upright,
// torque-actuated.
template <bool Fast>
struct PendulumDynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr bool kExactIsFast = false;
  static constexpr int S = 2;  // angle, angleD
  static constexpr int U = 1;  // torque command in [-1, 1]
  enum : int { kL = 0, kDamping, kG, kM, kUMax, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float L = p[kL];
    const float torque = u[0] * p[kUMax];
    d[0] = x[1];
    d[1] = (p[kG] / L * plant_sin<Fast>(x[0]) + torque / (p[kM] * (L * L))) -
           p[kDamping] * x[1];
  }

  // f and theta_dd's partials a0 (angle), a1 (angleD), au (u)
  // (ops/adjoints.py pendulum_derivs_jac).
  __device__ __forceinline__ static void jac(const float (&x)[S], const float (&u)[U],
                                             const float* p, float (&d)[S], float& a0,
                                             float& a1, float& au) {
    const float L = p[kL];
    float sin_t, dsin;
    plant_sin_d<Fast>(x[0], sin_t, dsin);
    const float gl = p[kG] / L;
    const float inv_ml2 = 1.0f / (p[kM] * (L * L));
    d[0] = x[1];
    d[1] = (gl * sin_t + u[0] * p[kUMax] * inv_ml2) - p[kDamping] * x[1];
    a0 = gl * dsin;
    a1 = -p[kDamping];
    au = p[kUMax] * inv_ml2;
  }

  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    float d[S], a0, a1, au;
    jac(x, u, p, d, a0, a1, au);
    dx[0] = lam[1] * a0;
    dx[1] = lam[0] + lam[1] * a1;
    du[0] = lam[1] * au;
  }

  template <int N>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    float a0, a1, au;
    jac(x, u, p, d, a0, a1, au);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dk[0][n] = T[1][n];
      dk[1][n] = fmaf(a1, T[1][n], fmaf(a0, T[0][n], n == S ? au : 0.0f));
    }
  }
};

// Acrobot dynamics (models/dynamics.py:_acrobot_derivs): two links, the
// elbow actuated; theta1 = 0 hanging down.
template <bool Fast>
struct AcrobotDynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr bool kExactIsFast = false;
  static constexpr int S = 4;  // theta1, theta1D, theta2, theta2D
  static constexpr int U = 1;  // elbow torque command in [-1, 1]
  enum : int { kI1 = 0, kI2, kG, kL1, kL2, kLc1, kLc2, kM1, kM2, kUMax, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float t1 = x[0], t1d = x[1], t2 = x[2], t2d = x[3];
    const float tau = u[0] * p[kUMax];
    const float m1 = p[kM1], m2 = p[kM2], l1 = p[kL1], lc1 = p[kLc1], lc2 = p[kLc2];
    const float I1 = p[kI1], I2 = p[kI2], g = p[kG];
    float s2, c2;
    if constexpr (Fast) {
      fast_sincos(t2, s2, c2);
    } else {
      s2 = sinf(t2);
      c2 = cosf(t2);
    }
    const float d1 =
        ((m1 * (lc1 * lc1) + m2 * ((l1 * l1 + lc2 * lc2) + 2.0f * l1 * lc2 * c2)) + I1) + I2;
    const float d2 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + I2;
    const float phi2 = m2 * lc2 * g * plant_sin<Fast>(t1 + t2);
    const float phi1 = ((-m2 * l1 * lc2 * (t2d * t2d) * s2 - 2.0f * m2 * l1 * lc2 * t2d * t1d * s2) +
                        (m1 * lc1 + m2 * l1) * g * plant_sin<Fast>(t1)) +
                       phi2;
    const float t2dd = (((tau + (d2 / d1) * phi1) - m2 * l1 * lc2 * (t1d * t1d) * s2) - phi2) /
                       ((m2 * (lc2 * lc2) + I2) - (d2 * d2) / d1);
    const float t1dd = -(d2 * t2dd + phi1) / d1;
    d[0] = t1d;
    d[1] = t1dd;
    d[2] = t2d;
    d[3] = t2dd;
  }

  // f and the partials of t1dd (a) and t2dd (b) in (t1, t1d, t2, t2d, u)
  // (ops/adjoints.py acrobot_derivs_jac, term for term).
  __device__ __forceinline__ static void jac(const float (&x)[S], const float (&u)[U],
                                             const float* p, float (&d)[S], float (&a)[S + U],
                                             float (&b)[S + U]) {
    const float t1 = x[0], t1d = x[1], t2 = x[2], t2d = x[3];
    const float tau = u[0] * p[kUMax];
    const float m1 = p[kM1], m2 = p[kM2], l1 = p[kL1], lc1 = p[kLc1], lc2 = p[kLc2];
    const float I1 = p[kI1], I2 = p[kI2], g = p[kG];
    float s2, c2, ds2, ndc2, s1, ds1, s12, ds12;
    plant_sincos_d<Fast>(t2, s2, c2, ds2, ndc2);
    plant_sin_d<Fast>(t1, s1, ds1);
    plant_sin_d<Fast>(t1 + t2, s12, ds12);
    const float h = m2 * l1 * lc2;
    const float d1 = m1 * (lc1 * lc1) + m2 * (l1 * l1 + lc2 * lc2 + 2.0f * l1 * lc2 * c2) + I1 + I2;
    const float d2 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + I2;
    const float dd1 = -(2.0f * h * ndc2), dd2 = -(h * ndc2);
    const float k2 = m2 * lc2 * g, k1 = (m1 * lc1 + m2 * l1) * g;
    const float phi2 = k2 * s12, dphi2 = k2 * ds12;
    const float phi1 = -h * (t2d * t2d) * s2 - 2.0f * h * t2d * t1d * s2 + k1 * s1 + phi2;
    const float f1 = k1 * ds1 + dphi2;
    const float f2 = -(2.0f * h * t2d * s2);
    const float f3 = -(h * (t2d * t2d) + 2.0f * h * t2d * t1d) * ds2 + dphi2;
    const float f4 = -(2.0f * h * t2d * s2) - 2.0f * h * t1d * s2;
    const float inv_d1 = 1.0f / d1;
    const float r = d2 * inv_d1;
    const float dr = (dd2 - r * dd1) * inv_d1;
    const float num = tau + r * phi1 - h * (t1d * t1d) * s2 - phi2;
    const float inv_den = 1.0f / (m2 * (lc2 * lc2) + I2 - d2 * d2 * inv_d1);
    const float dden = -(2.0f * r * dd2 - r * r * dd1);
    const float t2dd = num * inv_den;
    const float t1dd = -(d2 * t2dd + phi1) * inv_d1;
    d[0] = t1d;
    d[1] = t1dd;
    d[2] = t2d;
    d[3] = t2dd;
    b[0] = (r * f1 - dphi2) * inv_den;
    b[1] = (r * f2 - 2.0f * h * t1d * s2) * inv_den;
    b[2] = (dr * phi1 + r * f3 - h * (t1d * t1d) * ds2 - dphi2 - t2dd * dden) * inv_den;
    b[3] = r * f4 * inv_den;
    b[4] = p[kUMax] * inv_den;
    a[0] = -(d2 * b[0] + f1) * inv_d1;
    a[1] = -(d2 * b[1] + f2) * inv_d1;
    a[2] = -(dd2 * t2dd + d2 * b[2] + f3 + t1dd * dd1) * inv_d1;
    a[3] = -(d2 * b[3] + f4) * inv_d1;
    a[4] = -(d2 * b[4]) * inv_d1;
  }

  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    float d[S], a[S + U], b[S + U];
    jac(x, u, p, d, a, b);
    dx[0] = lam[1] * a[0] + lam[3] * b[0];
    dx[1] = lam[0] + (lam[1] * a[1] + lam[3] * b[1]);
    dx[2] = lam[1] * a[2] + lam[3] * b[2];
    dx[3] = lam[2] + (lam[1] * a[3] + lam[3] * b[3]);
    du[0] = lam[1] * a[4] + lam[3] * b[4];
  }

  template <int N>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    float a[S + U], b[S + U];
    jac(x, u, p, d, a, b);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dk[0][n] = T[1][n];
      dk[2][n] = T[3][n];
      dk[1][n] = fmaf(a[3], T[3][n],
                      fmaf(a[2], T[2][n], fmaf(a[1], T[1][n], fmaf(a[0], T[0][n],
                                                                   n == S ? a[4] : 0.0f))));
      dk[3][n] = fmaf(b[3], T[3][n],
                      fmaf(b[2], T[2][n], fmaf(b[1], T[1][n], fmaf(b[0], T[0][n],
                                                                   n == S ? b[4] : 0.0f))));
    }
  }
};

// Planar point mass (models/dynamics.py:pointmass_derivs_soa): two force
// inputs, linear, no trig.
struct PointmassDynamics {
  static constexpr bool kFast = false;
  static constexpr bool kExactIsFast = true;
  static constexpr int S = 4;  // x, y, xD, yD
  static constexpr int U = 2;  // force commands in [-1, 1]
  enum : int { kDrag = 0, kMass, kUMax, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float inv_m = 1.0f / p[kMass];
    d[0] = x[2];
    d[1] = x[3];
    d[2] = (u[0] * p[kUMax] - p[kDrag] * x[2]) * inv_m;
    d[3] = (u[1] * p[kUMax] - p[kDrag] * x[3]) * inv_m;
  }

  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    const float inv_m = 1.0f / p[kMass];
    const float dv = -p[kDrag] * inv_m, dc = p[kUMax] * inv_m;
    dx[0] = 0.0f;
    dx[1] = 0.0f;
    dx[2] = lam[0] + lam[2] * dv;
    dx[3] = lam[1] + lam[3] * dv;
    du[0] = lam[2] * dc;
    du[1] = lam[3] * dc;
  }

  template <int N>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    derivs(x, u, p, d);
    const float inv_m = 1.0f / p[kMass];
    const float dv = -p[kDrag] * inv_m, dc = p[kUMax] * inv_m;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dk[0][n] = T[2][n];
      dk[1][n] = T[3][n];
      dk[2][n] = fmaf(dv, T[2][n], n == S ? dc : 0.0f);
      dk[3][n] = fmaf(dv, T[3][n], n == S + 1 ? dc : 0.0f);
    }
  }
};

// The derivative of max(v, 0) in v as jax.vjp takes it: 1 above 0, 0 below,
// 1/2 at the tie (ops/adjoints.py _tie).
__device__ __forceinline__ float hinge_tie(float v) {
  return v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
}

// The pendulum/default cost (costs/pendulum.py): angle error, energy error
// (E - m g L)^2, the velocity penalty gated to near upright, the control
// cost; no control-change or terminal term.
struct PendulumCost {
  static constexpr int S = 2;
  static constexpr int U = 1;
  enum : int {
    kL = 0, kAngleWeight, kControlWeight, kEnergyWeight, kG, kM, kVelocityWeight,
    kUPrev,
    kN = kUPrev + U
  };

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float angle = x[0], angle_d = x[1];
    const float m = c[kM], L = c[kL], g = c[kG];
    const float cos_a = cosf(angle);
    const float energy = 0.5f * m * (L * L) * (angle_d * angle_d) + m * g * L * cos_a;
    const float err = energy - m * g * L;
    const float near_top = 0.5f * (1.0f + cos_a);
    const float core = ((c[kAngleWeight] * (1.0f - cos_a) + c[kEnergyWeight] * (err * err)) +
                        c[kVelocityWeight] * near_top * (angle_d * angle_d)) +
                       c[kControlWeight] * (u[0] * u[0]);
    return core - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    return 0.0f;
  }

  // Gradient of ct * stage_cost (ops/adjoints.py pendulum_stage_vjp).
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    const float angle = x[0], angle_d = x[1];
    const float m = c[kM], L = c[kL], g = c[kG];
    const float cos_a = cosf(angle), sin_a = sinf(angle);
    const float mgl = m * g * L, ml2 = m * (L * L);
    const float energy = 0.5f * ml2 * (angle_d * angle_d) + mgl * cos_a;
    const float e2 = 2.0f * c[kEnergyWeight] * (energy - mgl);
    const float vw = c[kVelocityWeight];
    gx[0] = ct * (c[kAngleWeight] * sin_a - e2 * mgl * sin_a -
                  vw * 0.5f * sin_a * (angle_d * angle_d));
    gx[1] = ct * (e2 * ml2 * angle_d + vw * (0.5f * (1.0f + cos_a)) * 2.0f * angle_d);
    gu[0] = ct * 2.0f * c[kControlWeight] * u[0];
    gprev[0] = 0.0f;
  }

  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    g[0] = 0.0f;
    g[1] = 0.0f;
  }
};

// The acrobot/default cost (costs/acrobot.py): tip-height shaping, the
// velocity penalty gated to near the top, the control cost; no
// control-change or terminal term.
struct AcrobotCost {
  static constexpr int S = 4;
  static constexpr int U = 1;
  enum : int {
    kControlWeight = 0, kHeightWeight, kL1, kL2, kVelocityWeight,
    kUPrev,
    kN = kUPrev + U
  };

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float t1 = x[0], t1d = x[1], t2 = x[2], t2d = x[3];
    const float l1 = c[kL1], l2 = c[kL2];
    const float height = -l1 * cosf(t1) - l2 * cosf(t1 + t2);
    const float max_h = l1 + l2;
    const float top = fmaxf(height / max_h, 0.0f);
    const float near_top = top * top;
    const float core = (c[kHeightWeight] * (max_h - height) +
                        c[kVelocityWeight] * near_top * (t1d * t1d + t2d * t2d)) +
                       c[kControlWeight] * (u[0] * u[0]);
    return core - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    return 0.0f;
  }

  // Gradient of ct * stage_cost (ops/adjoints.py acrobot_stage_vjp): the
  // near-top hinge's tie split in half.
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    const float t1 = x[0], t1d = x[1], t2 = x[2], t2d = x[3];
    const float l1 = c[kL1], l2 = c[kL2];
    const float s12 = sinf(t1 + t2);
    const float height = -l1 * cosf(t1) - l2 * cosf(t1 + t2);
    const float max_h = l1 + l2;
    const float hm = height / max_h;
    const float top = fmaxf(hm, 0.0f);
    const float near_top = top * top;
    const float vw = c[kVelocityWeight];
    const float vsum = t1d * t1d + t2d * t2d;
    const float dh = -c[kHeightWeight] + vw * vsum * (2.0f * top * hinge_tie(hm) / max_h);
    gx[0] = ct * dh * (l1 * sinf(t1) + l2 * s12);
    gx[1] = ct * vw * near_top * 2.0f * t1d;
    gx[2] = ct * dh * (l2 * s12);
    gx[3] = ct * vw * near_top * 2.0f * t2d;
    gu[0] = ct * 2.0f * c[kControlWeight] * u[0];
    gprev[0] = 0.0f;
  }

  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
#pragma unroll
    for (int i = 0; i < S; ++i) g[i] = 0.0f;
  }
};

// The point-mass costs (costs/pointmass.py) over a packed layout whose
// indices the template takes: pointmass/default (PointmassCost) and, with
// the obstacles' nine attributes from kObs (obstacle i's r, x, y at kObs +
// 3 i) and their two weights, pointmass/obstacles (PointmassObstacleCost:
// costs/obstacles.py's smooth hinge added to the stage and terminal costs).
template <int kR, int kCcWeight, int kCcrcWeight, int kPosWeight, int kVelWeight, int kTargetX,
          int kTargetY, int kUPrev_, int kClearance = -1, int kObstacleWeight = -1,
          int kObs = -1>
struct PointmassCostT {
  static constexpr int S = 4;
  static constexpr int U = 2;
  static constexpr int kUPrev = kUPrev_;
  static constexpr int kN = kUPrev + U;
  static constexpr bool kObstacles = kObs >= 0;
  static constexpr int kObstacleCount = 3;

  // obstacle_weight * sum_i max(0, 1 - d_i^2 / margin_i^2)^2 at (x, y).
  __device__ __forceinline__ static float penalty(float x, float y, const float* c) {
    float pen = 0.0f;
#pragma unroll
    for (int i = 0; i < kObstacleCount; ++i) {
      const float margin = c[kObs + 3 * i] + c[kClearance];
      const float dx = x - c[kObs + 3 * i + 1], dy = y - c[kObs + 3 * i + 2];
      const float h = fmaxf(0.0f, 1.0f - (dx * dx + dy * dy) / (margin * margin));
      pen = pen + h * h;
    }
    return c[kObstacleWeight] * pen;
  }

  // The penalty's gradient times ct, added to g[0] and g[1]
  // (ops/adjoints.py obstacle_penalty_grad).
  __device__ __forceinline__ static void penalty_grad(float x, float y, const float* c, float ct,
                                                      float& gx, float& gy) {
    float ax = 0.0f, ay = 0.0f;
#pragma unroll
    for (int i = 0; i < kObstacleCount; ++i) {
      const float margin = c[kObs + 3 * i] + c[kClearance];
      const float m2 = margin * margin;
      const float dx = x - c[kObs + 3 * i + 1], dy = y - c[kObs + 3 * i + 2];
      const float v = 1.0f - (dx * dx + dy * dy) / m2;
      const float coef = 2.0f * fmaxf(0.0f, v) * hinge_tie(v) * (-2.0f / m2);
      ax = ax + coef * dx;
      ay = ay + coef * dy;
    }
    const float w = ct * c[kObstacleWeight];
    gx = gx + w * ax;
    gy = gy + w * ay;
  }

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float dx = x[0] - c[kTargetX], dy = x[1] - c[kTargetY];
    const float pos = c[kPosWeight] * (dx * dx + dy * dy);
    const float vel = c[kVelWeight] * (x[2] * x[2] + x[3] * x[3]);
    float usq = 0.0f, dusq = 0.0f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      usq = usq + u[j] * u[j];
      const float du = u[j] - prev[j];
      dusq = dusq + du * du;
    }
    float core = (pos + vel) + c[kCcWeight] * c[kR] * usq;
    if constexpr (kObstacles) core = core + penalty(x[0], x[1], c);
    return (core + c[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    const float dx = x[0] - c[kTargetX], dy = x[1] - c[kTargetY];
    float out = 10.0f * c[kPosWeight] * (dx * dx + dy * dy) +
                c[kVelWeight] * (x[2] * x[2] + x[3] * x[3]);
    if constexpr (kObstacles) out = out + penalty(x[0], x[1], c);
    return out;
  }

  // Gradient of ct * stage_cost (ops/adjoints.py pointmass_stage_vjp,
  // pointmass_obstacle_stage_vjp).
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    const float pw = 2.0f * c[kPosWeight], vw = 2.0f * c[kVelWeight];
    gx[0] = ct * pw * (x[0] - c[kTargetX]);
    gx[1] = ct * pw * (x[1] - c[kTargetY]);
    gx[2] = ct * vw * x[2];
    gx[3] = ct * vw * x[3];
    if constexpr (kObstacles) penalty_grad(x[0], x[1], c, ct, gx[0], gx[1]);
    const float cc = 2.0f * c[kCcWeight] * c[kR];
    const float ccrc = 2.0f * c[kCcrcWeight];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float dchange = ct * ccrc * (u[j] - prev[j]);
      gu[j] = ct * cc * u[j] + dchange;
      gprev[j] = -dchange;
    }
  }

  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    const float pw = 20.0f * c[kPosWeight], vw = 2.0f * c[kVelWeight];
    g[0] = ct * pw * (x[0] - c[kTargetX]);
    g[1] = ct * pw * (x[1] - c[kTargetY]);
    g[2] = ct * vw * x[2];
    g[3] = ct * vw * x[3];
    if constexpr (kObstacles) penalty_grad(x[0], x[1], c, ct, g[0], g[1]);
  }
};

// c_R, c_cc_weight, c_ccrc_weight, c_pos_weight, c_vel_weight, a_target_x,
// a_target_y, __u_prev_0, __u_prev_1.
using PointmassCost = PointmassCostT<0, 1, 2, 3, 4, 5, 6, 7>;
// c_R, c_cc_weight, c_ccrc_weight, c_clearance, c_obstacle_weight,
// c_pos_weight, c_vel_weight, a_obs0_r .. a_obs2_y, a_target_x, a_target_y,
// __u_prev_0, __u_prev_1.
using PointmassObstacleCost = PointmassCostT<0, 1, 2, 5, 6, 16, 17, 18, 3, 4, 7>;

// The ODE kernels' plant over dynamics without derivs_short: the dynamics'
// constants, then the cost's vector.  FastNormals (K3 over a plant whose
// exact dynamics double as the fast ones) draws the fast counter normals.
template <class Dyn, class CostT, bool FastNormals = Dyn::kFast>
struct PlantT {
  static_assert(Dyn::S == CostT::S && Dyn::U == CostT::U, "dynamics and cost dims differ");
  using Dynamics = Dyn;
  using Cost = CostT;
  static constexpr bool kFast = FastNormals;
  static constexpr bool kShortStep = false;
  static constexpr bool kExactIsFast = Dyn::kExactIsFast;
  static constexpr int S = Dyn::S;
  static constexpr int U = Dyn::U;
  static constexpr int kCost = Dyn::kN;
  static constexpr int kUPrev = kCost + Cost::kUPrev;
  static constexpr int kN = kCost + Cost::kN;

  struct Recips {};
  __device__ __forceinline__ static Recips recips(const float*) { return {}; }

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    Dyn::derivs(x, u, p, d);
  }
  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    Dyn::derivs_vjp(x, u, p, lam, dx, du);
  }
  template <int N>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    Dyn::derivs_tangent(x, u, p, T, d, dk);
  }
  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* p,
                                                     float max_cost) {
    return Cost::stage_cost(x, u, prev, p + kCost, max_cost);
  }
  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* p) {
    return Cost::terminal_cost(x, p + kCost);
  }
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* p,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    Cost::stage_cost_vjp(x, u, prev, p + kCost, ct, gx, gu, gprev);
  }
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* p,
                                                            float ct, float (&g)[S]) {
    Cost::terminal_cost_grad(x, p + kCost, ct, g);
  }
};

// This slice's instances (ops/kernels.py PLANT_IDS 2-7), named as the
// kernels' template arguments.
struct PendulumPlant : PlantT<PendulumDynamicsT<false>, PendulumCost> {};
struct PendulumFastPlant : PlantT<PendulumDynamicsT<true>, PendulumCost> {};
struct AcrobotPlant : PlantT<AcrobotDynamicsT<false>, AcrobotCost> {};
struct AcrobotFastPlant : PlantT<AcrobotDynamicsT<true>, AcrobotCost> {};
struct PointmassPlant : PlantT<PointmassDynamics, PointmassCost> {};
struct PointmassObstaclePlant : PlantT<PointmassDynamics, PointmassObstacleCost> {};
// K3's fast-normals instances over the point mass's exact dynamics.
struct PointmassFastNormalsPlant : PlantT<PointmassDynamics, PointmassCost, true> {};
struct PointmassObstacleFastNormalsPlant
    : PlantT<PointmassDynamics, PointmassObstacleCost, true> {};

template <class Plant>
struct FastNormalsOf;
template <>
struct FastNormalsOf<PointmassPlant> {
  using type = PointmassFastNormalsPlant;
};
template <>
struct FastNormalsOf<PointmassObstaclePlant> {
  using type = PointmassObstacleFastNormalsPlant;
};

}  // namespace ctt
