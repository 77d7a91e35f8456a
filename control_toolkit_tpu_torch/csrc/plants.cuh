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
// so its exact dynamics double as the fast ones (kExactIsFast): only the
// fully-fused kernels (K3's pass 1, K5, K6) take a fast-normals instance of
// it (FastNormalsOf), which draws the fast counter normals over the exact
// plant.
//
// The quadrotor2d (S=6, U=2), quadrotor3d (S=12, U=4), car and arm2
// plants follow the same pattern, each with its fast plant
// (Quadrotor2DDynamicsT, Quadrotor3DDynamicsT, CarDynamicsT,
// Arm2DynamicsT; Quadrotor2DCost, Quadrotor3DCost, CarCost,
// CarObstacleCost, Arm2Cost): the quadrotors' thrusts lie in [0, 1] (the
// bounds are the kernels' arguments), the 3-D quadrotor's secant is
// clamped by selects whose derivative takes jax.vjp's tie rule
// (secant_clamp_d), and car/obstacles shares the point mass's obstacle
// penalty (ObstaclePenalty).  Their car/obstacles has a fast plant of its
// own: the car's fast dynamics differ from its exact ones.
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
  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
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
  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    Dynamics::template derivs_tangent<N, N0>(x, u, p, T, d, dk);
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

  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
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

  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
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

  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
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

// costs/obstacles.py's smooth hinge over a packed layout whose indices the
// template takes: the obstacles' nine attributes from kObs (obstacle i's r,
// x, y at kObs + 3 i), clearance and obstacle_weight; pointmass/obstacles
// and car/obstacles share it.
template <int kObs, int kClearance, int kObstacleWeight>
struct ObstaclePenalty {
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

  // The penalty's gradient times ct, added to gx and gy
  // (ops/adjoints.py obstacle_penalty_grad).
  __device__ __forceinline__ static void grad(float x, float y, const float* c, float ct,
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
};

// The point-mass costs (costs/pointmass.py) over a packed layout whose
// indices the template takes: pointmass/default (PointmassCost) and, with
// the obstacles' nine attributes from kObs and their two weights,
// pointmass/obstacles (PointmassObstacleCost: ObstaclePenalty added to the
// stage and terminal costs).
template <int kR, int kCcWeight, int kCcrcWeight, int kPosWeight, int kVelWeight, int kTargetX,
          int kTargetY, int kUPrev_, int kClearance = -1, int kObstacleWeight = -1,
          int kObs = -1>
struct PointmassCostT {
  static constexpr int S = 4;
  static constexpr int U = 2;
  static constexpr int kUPrev = kUPrev_;
  static constexpr int kN = kUPrev + U;
  static constexpr bool kObstacles = kObs >= 0;
  using Obstacles = ObstaclePenalty<kObs, kClearance, kObstacleWeight>;

  __device__ __forceinline__ static float penalty(float x, float y, const float* c) {
    return Obstacles::penalty(x, y, c);
  }
  __device__ __forceinline__ static void penalty_grad(float x, float y, const float* c, float ct,
                                                      float& gx, float& gy) {
    Obstacles::grad(x, y, c, ct, gx, gy);
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

// sin and cos of a: exact trig's sinf and cosf, or the polynomials'.
template <bool Fast>
__device__ __forceinline__ void plant_sincos(float a, float& s, float& c) {
  if constexpr (Fast) {
    fast_sincos(a, s, c);
  } else {
    s = sinf(a);
    c = cosf(a);
  }
}

// Planar quadrotor dynamics (models/dynamics.py:_quadrotor2d_derivs): two
// one-sided thrusts, the pitch's sincos.
template <bool Fast>
struct Quadrotor2DDynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr bool kExactIsFast = false;
  static constexpr int S = 6;  // x, z, xD, zD, theta, thetaD
  static constexpr int U = 2;  // thrust commands in [0, 1]
  enum : int { kI = 0, kArm, kDrag, kG, kM, kUMax, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float t1 = u[0] * p[kUMax], t2 = u[1] * p[kUMax];
    const float thrust = t1 + t2;
    float sin_t, cos_t;
    plant_sincos<Fast>(x[4], sin_t, cos_t);
    const float inv_m = 1.0f / p[kM];
    d[0] = x[2];
    d[1] = x[3];
    d[2] = (-thrust * sin_t - p[kDrag] * x[2]) * inv_m;
    d[3] = (thrust * cos_t - p[kDrag] * x[3]) * inv_m - p[kG];
    d[4] = x[5];
    d[5] = (t2 - t1) * p[kArm] / p[kI];
  }

  // f and the nontrivial partials (ops/adjoints.py quadrotor2d_derivs_jac):
  // j.v the drag's, j.axt, j.azt the accelerations' in theta, j.axu, j.azu
  // theirs in either thrust, j.alu the pitch acceleration's in t2 (-j.alu
  // in t1).
  struct Jac {
    float v, axt, azt, axu, azu, alu;
  };
  __device__ __forceinline__ static Jac jac(const float (&x)[S], const float (&u)[U],
                                            const float* p, float (&d)[S]) {
    const float u_max = p[kUMax];
    const float t1 = u[0] * u_max, t2 = u[1] * u_max;
    const float thrust = t1 + t2;
    float sin_t, cos_t, dsin, ndcos;
    plant_sincos_d<Fast>(x[4], sin_t, cos_t, dsin, ndcos);
    const float inv_m = 1.0f / p[kM];
    const float ka = p[kArm] / p[kI];
    d[0] = x[2];
    d[1] = x[3];
    d[2] = (-thrust * sin_t - p[kDrag] * x[2]) * inv_m;
    d[3] = (thrust * cos_t - p[kDrag] * x[3]) * inv_m - p[kG];
    d[4] = x[5];
    d[5] = (t2 - t1) * ka;
    return {-p[kDrag] * inv_m, -(thrust * dsin) * inv_m, -(thrust * ndcos) * inv_m,
            -(u_max * sin_t) * inv_m, u_max * cos_t * inv_m, u_max * ka};
  }

  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    float d[S];
    const Jac j = jac(x, u, p, d);
    dx[0] = 0.0f;
    dx[1] = 0.0f;
    dx[2] = lam[0] + lam[2] * j.v;
    dx[3] = lam[1] + lam[3] * j.v;
    dx[4] = lam[2] * j.axt + lam[3] * j.azt;
    dx[5] = lam[4];
    const float common = lam[2] * j.axu + lam[3] * j.azu;
    du[0] = common - lam[5] * j.alu;
    du[1] = common + lam[5] * j.alu;
  }

  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
    const Jac j = jac(x, u, p, d);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dk[0][n] = T[2][n];
      dk[1][n] = T[3][n];
      dk[2][n] = fmaf(j.axt, T[4][n], fmaf(j.v, T[2][n], n >= S ? j.axu : 0.0f));
      dk[3][n] = fmaf(j.azt, T[4][n], fmaf(j.v, T[3][n], n >= S ? j.azu : 0.0f));
      dk[4][n] = T[5][n];
      dk[5][n] = n == S ? -j.alu : (n == S + 1 ? j.alu : 0.0f);
    }
  }
};

// d c_safe / d c of the clamped secant where(c >= 0, maximum(c, 0.15),
// minimum(c, -0.15)) as jax.vjp takes it (ops/adjoints.py secant_clamp_d):
// 1 where the clamp passes c, 0 where it holds, 1/2 at c = +-0.15; at c = 0
// the first branch's 0.
__device__ __forceinline__ float secant_clamp_d(float c) {
  return c >= 0.0f ? hinge_tie(c - 0.15f) : hinge_tie(-0.15f - c);
}

// The 3-D quadrotor's dynamics (models/dynamics.py:_quadrotor3d_derivs):
// four one-sided thrusts, ZYX Euler attitude, the secant clamped to
// |cos(theta)| >= 0.15 by selects.
template <bool Fast>
struct Quadrotor3DDynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr bool kExactIsFast = false;
  static constexpr int S = 12;  // x, y, z, xD, yD, zD, phi, theta, psi, p, q, r
  static constexpr int U = 4;   // thrust commands in [0, 1]
  enum : int { kIx = 0, kIy, kIz, kArm, kDrag, kG, kKYaw, kM, kUMax, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float phi = x[6], theta = x[7], psi = x[8], wp = x[9], wq = x[10], wr = x[11];
    const float u_max = p[kUMax];
    const float t1 = u[0] * u_max, t2 = u[1] * u_max, t3 = u[2] * u_max, t4 = u[3] * u_max;
    const float thrust = ((t1 + t2) + t3) + t4;
    float s_ph, c_ph, s_th, c_th, s_ps, c_ps;
    plant_sincos<Fast>(phi, s_ph, c_ph);
    plant_sincos<Fast>(theta, s_th, c_th);
    plant_sincos<Fast>(psi, s_ps, c_ps);
    const float inv_m = 1.0f / p[kM], drag = p[kDrag];
    d[0] = x[3];
    d[1] = x[4];
    d[2] = x[5];
    d[3] = (thrust * (c_ph * s_th * c_ps + s_ph * s_ps) - drag * x[3]) * inv_m;
    d[4] = (thrust * (c_ph * s_th * s_ps - s_ph * c_ps) - drag * x[4]) * inv_m;
    d[5] = (thrust * (c_ph * c_th) - drag * x[5]) * inv_m - p[kG];
    const float cs = c_th >= 0.0f ? fmaxf(c_th, 0.15f) : fminf(c_th, -0.15f);
    const float tan_th = s_th / cs;
    d[6] = wp + (s_ph * wq + c_ph * wr) * tan_th;
    d[7] = c_ph * wq - s_ph * wr;
    d[8] = (s_ph * wq + c_ph * wr) / cs;
    const float Ix = p[kIx], Iy = p[kIy], Iz = p[kIz], arm = p[kArm];
    d[9] = ((Iy - Iz) * wq * wr + arm * (t2 - t4)) / Ix;
    d[10] = ((Iz - Ix) * wp * wr + arm * (t3 - t1)) / Iy;
    d[11] = ((Ix - Iy) * wp * wq + p[kKYaw] * (((t1 - t2) + t3) - t4)) / Iz;
  }

  // f and the Jacobian's nontrivial entries (ops/adjoints.py
  // quadrotor3d_derivs_jac): the accelerations' (drag v; a_, b_, c_ in
  // phi, theta, psi; au, bu, cu in every thrust), the Euler rates' (r6, r8
  // in phi, theta, q, r; r7 in phi, q, r) and the body rates' (r9 in q, r;
  // r10 in p, r; r11 in p, q; kx, ky, kz the torques' thrust partials).
  struct Jac {
    float v, a[3], b[3], c[2], au, bu, cu, r6[4], r7[3], r8[4], r9[2], r10[2], r11[2], kx, ky,
        kz;
  };
  __device__ __forceinline__ static Jac jac(const float (&x)[S], const float (&u)[U],
                                            const float* p, float (&d)[S]) {
    const float phi = x[6], theta = x[7], psi = x[8], wp = x[9], wq = x[10], wr = x[11];
    const float u_max = p[kUMax];
    const float t1 = u[0] * u_max, t2 = u[1] * u_max, t3 = u[2] * u_max, t4 = u[3] * u_max;
    const float thrust = ((t1 + t2) + t3) + t4;
    float s_ph, c_ph, ds_ph, ndc_ph, s_th, c_th, ds_th, ndc_th, s_ps, c_ps, ds_ps, ndc_ps;
    plant_sincos_d<Fast>(phi, s_ph, c_ph, ds_ph, ndc_ph);
    plant_sincos_d<Fast>(theta, s_th, c_th, ds_th, ndc_th);
    plant_sincos_d<Fast>(psi, s_ps, c_ps, ds_ps, ndc_ps);
    const float inv_m = 1.0f / p[kM], drag = p[kDrag];
    const float A = c_ph * s_th * c_ps + s_ph * s_ps;
    const float B = c_ph * s_th * s_ps - s_ph * c_ps;
    const float C = c_ph * c_th;
    d[0] = x[3];
    d[1] = x[4];
    d[2] = x[5];
    d[3] = (thrust * A - drag * x[3]) * inv_m;
    d[4] = (thrust * B - drag * x[4]) * inv_m;
    d[5] = (thrust * C - drag * x[5]) * inv_m - p[kG];
    const float cs = c_th >= 0.0f ? fmaxf(c_th, 0.15f) : fminf(c_th, -0.15f);
    const float dcs = -(secant_clamp_d(c_th) * ndc_th);  // d c_safe / d theta
    const float tan_th = s_th / cs;
    const float wn = s_ph * wq + c_ph * wr;
    d[6] = wp + wn * tan_th;
    d[7] = c_ph * wq - s_ph * wr;
    d[8] = wn / cs;
    const float Ix = p[kIx], Iy = p[kIy], Iz = p[kIz], arm = p[kArm];
    d[9] = ((Iy - Iz) * wq * wr + arm * (t2 - t4)) / Ix;
    d[10] = ((Iz - Ix) * wp * wr + arm * (t3 - t1)) / Iy;
    d[11] = ((Ix - Iy) * wp * wq + p[kKYaw] * (((t1 - t2) + t3) - t4)) / Iz;
    const float tm = thrust * inv_m;
    const float dwn = ds_ph * wq - ndc_ph * wr;  // d wn / d phi
    const float dtan = (ds_th - tan_th * dcs) / cs;
    Jac j;
    j.v = -drag * inv_m;
    j.a[0] = tm * (ds_ph * s_ps - ndc_ph * s_th * c_ps);
    j.a[1] = tm * (c_ph * ds_th * c_ps);
    j.a[2] = tm * (s_ph * ds_ps - c_ph * s_th * ndc_ps);
    j.b[0] = tm * (-(ndc_ph * s_th * s_ps) - ds_ph * c_ps);
    j.b[1] = tm * (c_ph * ds_th * s_ps);
    j.b[2] = tm * (c_ph * s_th * ds_ps + s_ph * ndc_ps);
    j.c[0] = tm * -(ndc_ph * c_th);
    j.c[1] = tm * -(c_ph * ndc_th);
    j.au = u_max * A * inv_m;
    j.bu = u_max * B * inv_m;
    j.cu = u_max * C * inv_m;
    j.r6[0] = dwn * tan_th;
    j.r6[1] = wn * dtan;
    j.r6[2] = s_ph * tan_th;
    j.r6[3] = c_ph * tan_th;
    j.r7[0] = -(ndc_ph * wq) - ds_ph * wr;
    j.r7[1] = c_ph;
    j.r7[2] = -s_ph;
    j.r8[0] = dwn / cs;
    j.r8[1] = -(d[8] * dcs) / cs;
    j.r8[2] = s_ph / cs;
    j.r8[3] = c_ph / cs;
    j.r9[0] = (Iy - Iz) * wr / Ix;
    j.r9[1] = (Iy - Iz) * wq / Ix;
    j.r10[0] = (Iz - Ix) * wr / Iy;
    j.r10[1] = (Iz - Ix) * wp / Iy;
    j.r11[0] = (Ix - Iy) * wq / Iz;
    j.r11[1] = (Ix - Iy) * wp / Iz;
    j.kx = arm * u_max / Ix;
    j.ky = arm * u_max / Iy;
    j.kz = p[kKYaw] * u_max / Iz;
    return j;
  }

  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    float d[S];
    const Jac j = jac(x, u, p, d);
    dx[0] = 0.0f;
    dx[1] = 0.0f;
    dx[2] = 0.0f;
    dx[3] = lam[0] + lam[3] * j.v;
    dx[4] = lam[1] + lam[4] * j.v;
    dx[5] = lam[2] + lam[5] * j.v;
    dx[6] = lam[3] * j.a[0] + lam[4] * j.b[0] + lam[5] * j.c[0] + lam[6] * j.r6[0] +
            lam[7] * j.r7[0] + lam[8] * j.r8[0];
    dx[7] = lam[3] * j.a[1] + lam[4] * j.b[1] + lam[5] * j.c[1] + lam[6] * j.r6[1] +
            lam[8] * j.r8[1];
    dx[8] = lam[3] * j.a[2] + lam[4] * j.b[2];
    dx[9] = lam[6] + lam[10] * j.r10[0] + lam[11] * j.r11[0];
    dx[10] = lam[6] * j.r6[2] + lam[7] * j.r7[1] + lam[8] * j.r8[2] + lam[9] * j.r9[0] +
             lam[11] * j.r11[1];
    dx[11] = lam[6] * j.r6[3] + lam[7] * j.r7[2] + lam[8] * j.r8[3] + lam[9] * j.r9[1] +
             lam[10] * j.r10[1];
    const float acc = lam[3] * j.au + lam[4] * j.bu + lam[5] * j.cu;
    du[0] = acc - lam[10] * j.ky + lam[11] * j.kz;
    du[1] = acc + lam[9] * j.kx - lam[11] * j.kz;
    du[2] = acc + lam[10] * j.ky + lam[11] * j.kz;
    du[3] = acc - lam[9] * j.kx - lam[11] * j.kz;
  }

  // N columns of the tangent from column N0 (K7's adjoint takes the 3-D
  // quadrotor's 16 columns a few at a time: AdjGeometry::kCols).
  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    const Jac j = jac(x, u, p, d);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int n = i + N0;  // the column of [T; E]
      const bool ctl = n >= S;
      dk[0][i] = T[3][i];
      dk[1][i] = T[4][i];
      dk[2][i] = T[5][i];
      dk[3][i] = fmaf(j.a[2], T[8][i], fmaf(j.a[1], T[7][i], fmaf(j.a[0], T[6][i],
                      fmaf(j.v, T[3][i], ctl ? j.au : 0.0f))));
      dk[4][i] = fmaf(j.b[2], T[8][i], fmaf(j.b[1], T[7][i], fmaf(j.b[0], T[6][i],
                      fmaf(j.v, T[4][i], ctl ? j.bu : 0.0f))));
      dk[5][i] = fmaf(j.c[1], T[7][i], fmaf(j.c[0], T[6][i], fmaf(j.v, T[5][i],
                      ctl ? j.cu : 0.0f)));
      dk[6][i] = fmaf(j.r6[3], T[11][i], fmaf(j.r6[2], T[10][i], fmaf(j.r6[1], T[7][i],
                      fmaf(j.r6[0], T[6][i], T[9][i]))));
      dk[7][i] = fmaf(j.r7[2], T[11][i], fmaf(j.r7[1], T[10][i], j.r7[0] * T[6][i]));
      dk[8][i] = fmaf(j.r8[3], T[11][i], fmaf(j.r8[2], T[10][i], fmaf(j.r8[1], T[7][i],
                      j.r8[0] * T[6][i])));
      dk[9][i] = fmaf(j.r9[1], T[11][i], fmaf(j.r9[0], T[10][i],
                      n == S + 1 ? j.kx : (n == S + 3 ? -j.kx : 0.0f)));
      dk[10][i] = fmaf(j.r10[1], T[11][i], fmaf(j.r10[0], T[9][i],
                       n == S + 2 ? j.ky : (n == S ? -j.ky : 0.0f)));
      dk[11][i] = fmaf(j.r11[1], T[10][i], fmaf(j.r11[0], T[9][i],
                       ctl ? ((n - S) % 2 == 0 ? j.kz : -j.kz) : 0.0f));
    }
  }
};

// The kinematic bicycle car (models/dynamics.py:_car_derivs): the heading's
// and the steering's sincos, tan(steer) = s / c a division.
template <bool Fast>
struct CarDynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr bool kExactIsFast = false;
  static constexpr int S = 4;  // x, y, yaw, v
  static constexpr int U = 2;  // steering and acceleration commands in [-1, 1]
  enum : int { kAccelMax = 0, kDrag, kSteerMax, kVMax, kWheelbase, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float v = x[3];
    const float steer = u[0] * p[kSteerMax], accel = u[1] * p[kAccelMax];
    float s_y, c_y, s_d, c_d;
    plant_sincos<Fast>(x[2], s_y, c_y);
    plant_sincos<Fast>(steer, s_d, c_d);
    const float r = v / p[kVMax];
    d[0] = v * c_y;
    d[1] = v * s_y;
    d[2] = v * (s_d / c_d) / p[kWheelbase];
    d[3] = accel - p[kDrag] * v * (1.0f + r * r);
  }

  // f and the nontrivial partials (ops/adjoints.py car_derivs_jac): x' and
  // y' in yaw and v, yaw' in v and the steering, v' in v.
  struct Jac {
    float xy, xv, yy, yv, wv, wu, vv;
  };
  __device__ __forceinline__ static Jac jac(const float (&x)[S], const float (&u)[U],
                                            const float* p, float (&d)[S]) {
    const float v = x[3];
    const float smax = p[kSteerMax], wb = p[kWheelbase], vmax = p[kVMax], drag = p[kDrag];
    const float steer = u[0] * smax, accel = u[1] * p[kAccelMax];
    float s_y, c_y, ds_y, ndc_y, s_d, c_d, ds_d, ndc_d;
    plant_sincos_d<Fast>(x[2], s_y, c_y, ds_y, ndc_y);
    plant_sincos_d<Fast>(steer, s_d, c_d, ds_d, ndc_d);
    const float tan_d = s_d / c_d;
    const float r = v / vmax;
    d[0] = v * c_y;
    d[1] = v * s_y;
    d[2] = v * tan_d / wb;
    d[3] = accel - drag * v * (1.0f + r * r);
    const float dtan = (ds_d * c_d + s_d * ndc_d) / (c_d * c_d);
    return {-(v * ndc_y), c_y, v * ds_y, s_y, tan_d / wb, v * dtan * smax / wb,
            -drag * (1.0f + r * r) - drag * v * 2.0f * r / vmax};
  }

  __device__ __forceinline__ static void derivs_vjp(const float (&x)[S], const float (&u)[U],
                                                    const float* p, const float (&lam)[S],
                                                    float (&dx)[S], float (&du)[U]) {
    float d[S];
    const Jac j = jac(x, u, p, d);
    dx[0] = 0.0f;
    dx[1] = 0.0f;
    dx[2] = lam[0] * j.xy + lam[1] * j.yy;
    dx[3] = lam[0] * j.xv + lam[1] * j.yv + lam[2] * j.wv + lam[3] * j.vv;
    du[0] = lam[2] * j.wu;
    du[1] = lam[3] * p[kAccelMax];
  }

  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
    const Jac j = jac(x, u, p, d);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dk[0][n] = fmaf(j.xv, T[3][n], j.xy * T[2][n]);
      dk[1][n] = fmaf(j.yv, T[3][n], j.yy * T[2][n]);
      dk[2][n] = fmaf(j.wv, T[3][n], n == S ? j.wu : 0.0f);
      dk[3][n] = fmaf(j.vv, T[3][n], n == S + 1 ? p[kAccelMax] : 0.0f);
    }
  }
};

// The two-link arm (models/dynamics.py:_arm2_derivs): both joints
// torque-actuated, viscous damping; three sincos (theta2, theta1,
// theta1 + theta2).
template <bool Fast>
struct Arm2DynamicsT {
  static constexpr bool kFast = Fast;
  static constexpr bool kExactIsFast = false;
  static constexpr int S = 4;  // theta1, theta1D, theta2, theta2D
  static constexpr int U = 2;  // joint torque commands in [-1, 1]
  enum : int { kI1 = 0, kI2, kB, kG, kL1, kL2, kLc1, kLc2, kM1, kM2, kUMax, kN };

  __device__ __forceinline__ static void derivs(const float (&x)[S], const float (&u)[U],
                                                const float* p, float (&d)[S]) {
    const float t1 = x[0], t1d = x[1], t2 = x[2], t2d = x[3];
    const float tau1 = u[0] * p[kUMax], tau2 = u[1] * p[kUMax];
    const float m1 = p[kM1], m2 = p[kM2], l1 = p[kL1], lc1 = p[kLc1], lc2 = p[kLc2];
    const float I1 = p[kI1], I2 = p[kI2], g = p[kG], b = p[kB];
    float s2, c2, s1, c1, s12, c12;
    plant_sincos<Fast>(t2, s2, c2);
    plant_sincos<Fast>(t1, s1, c1);
    plant_sincos<Fast>(t1 + t2, s12, c12);
    const float h = m2 * l1 * lc2;
    const float M11 =
        ((m1 * (lc1 * lc1) + m2 * ((l1 * l1 + lc2 * lc2) + 2.0f * l1 * lc2 * c2)) + I1) + I2;
    const float M12 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + I2;
    const float M22 = m2 * (lc2 * lc2) + I2;
    const float g1 = (m1 * lc1 + m2 * l1) * g * s1 + m2 * lc2 * g * s12;
    const float g2 = m2 * lc2 * g * s12;
    const float r1 = ((tau1 + h * s2 * (t2d * t2d + 2.0f * t1d * t2d)) - g1) - b * t1d;
    const float r2 = ((tau2 - h * s2 * (t1d * t1d)) - g2) - b * t2d;
    const float det = M11 * M22 - M12 * M12;
    d[0] = t1d;
    d[1] = (M22 * r1 - M12 * r2) / det;
    d[2] = t2d;
    d[3] = (M11 * r2 - M12 * r1) / det;
  }

  // f and the partials of t1dd (a) and t2dd (b) in (t1, t1d, t2, t2d, u1,
  // u2) (ops/adjoints.py arm2_derivs_jac, term for term).
  __device__ __forceinline__ static void jac(const float (&x)[S], const float (&u)[U],
                                             const float* p, float (&d)[S], float (&a)[S + U],
                                             float (&bb)[S + U]) {
    const float t1 = x[0], t1d = x[1], t2 = x[2], t2d = x[3];
    const float u_max = p[kUMax];
    const float m1 = p[kM1], m2 = p[kM2], l1 = p[kL1], lc1 = p[kLc1], lc2 = p[kLc2];
    const float I1 = p[kI1], I2 = p[kI2], g = p[kG], b = p[kB];
    float s2, c2, ds2, ndc2, s1, c1, ds1, ndc1, s12, c12, ds12, ndc12;
    plant_sincos_d<Fast>(t2, s2, c2, ds2, ndc2);
    plant_sincos_d<Fast>(t1, s1, c1, ds1, ndc1);
    plant_sincos_d<Fast>(t1 + t2, s12, c12, ds12, ndc12);
    const float h = m2 * l1 * lc2;
    const float M11 = m1 * (lc1 * lc1) + m2 * (l1 * l1 + lc2 * lc2 + 2.0f * l1 * lc2 * c2) + I1 + I2;
    const float M12 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + I2;
    const float M22 = m2 * (lc2 * lc2) + I2;
    const float dM11 = -(2.0f * h * ndc2), dM12 = -(h * ndc2);
    const float k1 = (m1 * lc1 + m2 * l1) * g, k2 = m2 * lc2 * g;
    const float vv = t2d * t2d + 2.0f * t1d * t2d;
    const float r1 = u[0] * u_max + h * s2 * vv - (k1 * s1 + k2 * s12) - b * t1d;
    const float r2 = u[1] * u_max - h * s2 * (t1d * t1d) - k2 * s12 - b * t2d;
    const float det = M11 * M22 - M12 * M12;
    const float t1dd = (M22 * r1 - M12 * r2) / det;
    const float t2dd = (M11 * r2 - M12 * r1) / det;
    d[0] = t1d;
    d[1] = t1dd;
    d[2] = t2d;
    d[3] = t2dd;
    const float dr1[S + U] = {-(k1 * ds1 + k2 * ds12), h * s2 * 2.0f * t2d - b,
                              h * ds2 * vv - k2 * ds12, h * s2 * (2.0f * t2d + 2.0f * t1d),
                              u_max, 0.0f};
    const float dr2[S + U] = {-(k2 * ds12), -(h * s2 * 2.0f * t1d),
                              -(h * ds2 * (t1d * t1d)) - k2 * ds12, -b, 0.0f, u_max};
    const float ddet = dM11 * M22 - 2.0f * M12 * dM12;
#pragma unroll
    for (int n = 0; n < S + U; ++n) {
      float dn1 = M22 * dr1[n] - M12 * dr2[n];
      float dn2 = M11 * dr2[n] - M12 * dr1[n];
      if (n == 2) {
        dn1 = (dn1 - dM12 * r2) - t1dd * ddet;
        dn2 = ((dn2 + dM11 * r2) - dM12 * r1) - t2dd * ddet;
      }
      a[n] = dn1 / det;  // divisions, as the plain version's: det cancels
      bb[n] = dn2 / det;
    }
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
    du[1] = lam[1] * a[5] + lam[3] * b[5];
  }

  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    static_assert(N0 == 0, "the whole tangent, from column 0");
    float a[S + U], b[S + U];
    jac(x, u, p, d, a, b);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float ea = n == S ? a[4] : (n == S + 1 ? a[5] : 0.0f);
      const float eb = n == S ? b[4] : (n == S + 1 ? b[5] : 0.0f);
      dk[0][n] = T[1][n];
      dk[2][n] = T[3][n];
      dk[1][n] = fmaf(a[3], T[3][n], fmaf(a[2], T[2][n], fmaf(a[1], T[1][n],
                      fmaf(a[0], T[0][n], ea))));
      dk[3][n] = fmaf(b[3], T[3][n], fmaf(b[2], T[2][n], fmaf(b[1], T[1][n],
                      fmaf(b[0], T[0][n], eb))));
    }
  }
};

// The hover-thrust costs' control part: cc_weight * sum_j (u_j - hover)^2,
// the control-change sum beside it (costs/quadrotor2d.py,
// costs/quadrotor3d.py).
template <int U>
__device__ __forceinline__ void hover_sums(const float (&u)[U], const float (&prev)[U],
                                           float hover, float& usq, float& dusq) {
  usq = 0.0f;
  dusq = 0.0f;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const float e = u[j] - hover;
    usq = usq + e * e;
    const float du = u[j] - prev[j];
    dusq = dusq + du * du;
  }
}

// gu and gprev of ct * (cc * sum_j cu_j(u_j) + ccrc * sum_j (u_j - prev_j)^2)
// from gcc[j] = cc's gradient in u_j (ops/adjoints.py _control_grads).
template <int U>
__device__ __forceinline__ void control_grads(const float (&u)[U], const float (&prev)[U],
                                              const float (&gcc)[U], float ccrc_weight,
                                              float ct, float (&gu)[U], float (&gprev)[U]) {
  const float ccrc = 2.0f * ccrc_weight;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const float dchange = ct * ccrc * (u[j] - prev[j]);
    gu[j] = ct * gcc[j] + dchange;
    gprev[j] = -dchange;
  }
}

// The quadrotor2d/default cost (costs/quadrotor2d.py).
struct Quadrotor2DCost {
  static constexpr int S = 6;
  static constexpr int U = 2;
  enum : int {
    kCcWeight = 0, kCcrcWeight, kHoverThrust, kPosWeight, kRateWeight, kTiltWeight, kVelWeight,
    kTargetX, kTargetZ,
    kUPrev,
    kN = kUPrev + U
  };

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float dx = x[0] - c[kTargetX], dz = x[1] - c[kTargetZ];
    const float pos = c[kPosWeight] * (dx * dx + dz * dz);
    const float vel = c[kVelWeight] * (x[2] * x[2] + x[3] * x[3]);
    const float tilt = c[kTiltWeight] * (1.0f - cosf(x[4]));
    const float rate = c[kRateWeight] * (x[5] * x[5]);
    float usq, dusq;
    hover_sums<U>(u, prev, c[kHoverThrust], usq, dusq);
    const float core = (((pos + vel) + tilt) + rate) + c[kCcWeight] * usq;
    return (core + c[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    const float dx = x[0] - c[kTargetX], dz = x[1] - c[kTargetZ];
    return (10.0f * c[kPosWeight] * (dx * dx + dz * dz) +
            c[kVelWeight] * (x[2] * x[2] + x[3] * x[3])) +
           10.0f * c[kTiltWeight] * (1.0f - cosf(x[4]));
  }

  // ops/adjoints.py quadrotor2d_stage_vjp.
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    const float pw = 2.0f * c[kPosWeight], vw = 2.0f * c[kVelWeight];
    gx[0] = ct * pw * (x[0] - c[kTargetX]);
    gx[1] = ct * pw * (x[1] - c[kTargetZ]);
    gx[2] = ct * vw * x[2];
    gx[3] = ct * vw * x[3];
    gx[4] = ct * c[kTiltWeight] * sinf(x[4]);
    gx[5] = ct * (2.0f * c[kRateWeight]) * x[5];
    const float cc = 2.0f * c[kCcWeight];
    float gcc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) gcc[j] = cc * (u[j] - c[kHoverThrust]);
    control_grads<U>(u, prev, gcc, c[kCcrcWeight], ct, gu, gprev);
  }

  // ops/adjoints.py quadrotor2d_terminal_grad.
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    const float pw = 20.0f * c[kPosWeight], vw = 2.0f * c[kVelWeight];
    g[0] = ct * pw * (x[0] - c[kTargetX]);
    g[1] = ct * pw * (x[1] - c[kTargetZ]);
    g[2] = ct * vw * x[2];
    g[3] = ct * vw * x[3];
    g[4] = ct * (10.0f * c[kTiltWeight]) * sinf(x[4]);
    g[5] = 0.0f;
  }
};

// The quadrotor3d/default cost (costs/quadrotor3d.py).
struct Quadrotor3DCost {
  static constexpr int S = 12;
  static constexpr int U = 4;
  enum : int {
    kCcWeight = 0, kCcrcWeight, kHoverThrust, kPosWeight, kRateWeight, kTiltWeight, kVelWeight,
    kYawWeight, kTargetX, kTargetY, kTargetYaw, kTargetZ,
    kUPrev,
    kN = kUPrev + U
  };

  __device__ __forceinline__ static float squares3(const float (&x)[S], int i, float a, float b,
                                                   float cc) {
    const float d0 = x[i] - a, d1 = x[i + 1] - b, d2 = x[i + 2] - cc;
    return (d0 * d0 + d1 * d1) + d2 * d2;
  }

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float pos = c[kPosWeight] * squares3(x, 0, c[kTargetX], c[kTargetY], c[kTargetZ]);
    const float vel = c[kVelWeight] * squares3(x, 3, 0.0f, 0.0f, 0.0f);
    const float tilt = c[kTiltWeight] * ((2.0f - cosf(x[6])) - cosf(x[7]));
    const float yaw = c[kYawWeight] * (1.0f - cosf(x[8] - c[kTargetYaw]));
    const float rate = c[kRateWeight] * squares3(x, 9, 0.0f, 0.0f, 0.0f);
    float usq, dusq;
    hover_sums<U>(u, prev, c[kHoverThrust], usq, dusq);
    const float core = ((((pos + vel) + tilt) + yaw) + rate) + c[kCcWeight] * usq;
    return (core + c[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    return (10.0f * c[kPosWeight] * squares3(x, 0, c[kTargetX], c[kTargetY], c[kTargetZ]) +
            c[kVelWeight] * squares3(x, 3, 0.0f, 0.0f, 0.0f)) +
           10.0f * c[kTiltWeight] * ((2.0f - cosf(x[6])) - cosf(x[7]));
  }

  // ops/adjoints.py quadrotor3d_stage_vjp.
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    const float pw = 2.0f * c[kPosWeight], vw = 2.0f * c[kVelWeight];
    const float tw = c[kTiltWeight], rw = 2.0f * c[kRateWeight];
    gx[0] = ct * pw * (x[0] - c[kTargetX]);
    gx[1] = ct * pw * (x[1] - c[kTargetY]);
    gx[2] = ct * pw * (x[2] - c[kTargetZ]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gx[3 + i] = ct * vw * x[3 + i];
      gx[9 + i] = ct * rw * x[9 + i];
    }
    gx[6] = ct * tw * sinf(x[6]);
    gx[7] = ct * tw * sinf(x[7]);
    gx[8] = ct * c[kYawWeight] * sinf(x[8] - c[kTargetYaw]);
    const float cc = 2.0f * c[kCcWeight];
    float gcc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) gcc[j] = cc * (u[j] - c[kHoverThrust]);
    control_grads<U>(u, prev, gcc, c[kCcrcWeight], ct, gu, gprev);
  }

  // ops/adjoints.py quadrotor3d_terminal_grad.
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    const float pw = 20.0f * c[kPosWeight], vw = 2.0f * c[kVelWeight];
    const float tw = 10.0f * c[kTiltWeight];
    g[0] = ct * pw * (x[0] - c[kTargetX]);
    g[1] = ct * pw * (x[1] - c[kTargetY]);
    g[2] = ct * pw * (x[2] - c[kTargetZ]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[3 + i] = ct * vw * x[3 + i];
      g[9 + i] = 0.0f;
    }
    g[6] = ct * tw * sinf(x[6]);
    g[7] = ct * tw * sinf(x[7]);
    g[8] = 0.0f;
  }
};

// The car costs (costs/car.py) over a packed layout whose indices the
// template takes: car/default (CarCost) and, with the obstacles' nine
// attributes from kObs and their two weights, car/obstacles
// (CarObstacleCost: ObstaclePenalty added to the stage and terminal costs).
template <int kArriveRadius, int kCcWeight, int kCcrcWeight, int kPosWeight, int kSteerWeight,
          int kVelWeight, int kTargetX, int kTargetY, int kUPrev_, int kClearance = -1,
          int kObstacleWeight = -1, int kObs = -1>
struct CarCostT {
  static constexpr int S = 4;
  static constexpr int U = 2;
  static constexpr int kUPrev = kUPrev_;
  static constexpr int kN = kUPrev + U;
  static constexpr bool kObstacles = kObs >= 0;
  using Obstacles = ObstaclePenalty<kObs, kClearance, kObstacleWeight>;

  // costs/car.py _terms: pos_weight d2 + vel_weight near v^2, near = r2 / (r2 + d2).
  __device__ __forceinline__ static float terms(const float (&x)[S], const float* c) {
    const float dx = x[0] - c[kTargetX], dy = x[1] - c[kTargetY];
    const float d2 = dx * dx + dy * dy;
    const float r2 = c[kArriveRadius] * c[kArriveRadius];
    const float near = r2 / (r2 + d2);
    return c[kPosWeight] * d2 + c[kVelWeight] * near * (x[3] * x[3]);
  }

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float cc = c[kSteerWeight] * (u[0] * u[0]) + c[kCcWeight] * (u[1] * u[1]);
    float core = terms(x, c) + cc;
    if constexpr (kObstacles) core = core + Obstacles::penalty(x[0], x[1], c);
    float dusq = 0.0f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float du = u[j] - prev[j];
      dusq = dusq + du * du;
    }
    return (core + c[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    float out = 10.0f * terms(x, c);
    if constexpr (kObstacles) out = out + Obstacles::penalty(x[0], x[1], c);
    return out;
  }

  // The gradient of ct * terms (ops/adjoints.py _car_terms_grad).
  __device__ __forceinline__ static void terms_grad(const float (&x)[S], const float* c,
                                                    float ct, float (&g)[S]) {
    const float dx = x[0] - c[kTargetX], dy = x[1] - c[kTargetY];
    const float d2 = dx * dx + dy * dy;
    const float r2 = c[kArriveRadius] * c[kArriveRadius];
    const float near = r2 / (r2 + d2);
    const float v = x[3], vw = c[kVelWeight];
    const float coef = 2.0f * (c[kPosWeight] - vw * (v * v) * near / (r2 + d2));
    g[0] = ct * coef * dx;
    g[1] = ct * coef * dy;
    g[2] = 0.0f;
    g[3] = ct * (2.0f * vw) * near * v;
  }

  // ops/adjoints.py car_stage_vjp, car_obstacle_stage_vjp.
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    terms_grad(x, c, ct, gx);
    if constexpr (kObstacles) Obstacles::grad(x[0], x[1], c, ct, gx[0], gx[1]);
    const float gcc[U] = {2.0f * c[kSteerWeight] * u[0], 2.0f * c[kCcWeight] * u[1]};
    control_grads<U>(u, prev, gcc, c[kCcrcWeight], ct, gu, gprev);
  }

  // ops/adjoints.py car_terminal_grad, car_obstacle_terminal_grad.
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    terms_grad(x, c, 10.0f * ct, g);
    if constexpr (kObstacles) Obstacles::grad(x[0], x[1], c, ct, g[0], g[1]);
  }
};

// c_arrive_radius, c_cc_weight, c_ccrc_weight, c_pos_weight,
// c_steer_weight, c_vel_weight, a_target_x, a_target_y, __u_prev_0, __u_prev_1.
using CarCost = CarCostT<0, 1, 2, 3, 4, 5, 6, 7, 8>;
// c_arrive_radius, c_cc_weight, c_ccrc_weight, c_clearance,
// c_obstacle_weight, c_pos_weight, c_steer_weight, c_vel_weight, a_obs0_r ..
// a_obs2_y, a_target_x, a_target_y, __u_prev_0, __u_prev_1.
using CarObstacleCost = CarCostT<0, 1, 2, 5, 6, 7, 17, 18, 19, 3, 4, 8>;

// The arm2/default cost (costs/arm2.py): the fingertip
// (models/dynamics.py:arm2_end_effector, exact trig) to its target.
struct Arm2Cost {
  static constexpr int S = 4;
  static constexpr int U = 2;
  enum : int {
    kR = 0, kCcWeight, kCcrcWeight, kL1, kL2, kPosWeight, kVelWeight, kTargetX, kTargetY,
    kUPrev,
    kN = kUPrev + U
  };

  // The squared distance of the fingertip from the target.
  __device__ __forceinline__ static float reach(const float (&x)[S], const float* c) {
    const float l1 = c[kL1], l2 = c[kL2];
    const float ex = (l1 * sinf(x[0]) + l2 * sinf(x[0] + x[2])) - c[kTargetX];
    const float ey = (-l1 * cosf(x[0]) - l2 * cosf(x[0] + x[2])) - c[kTargetY];
    return ex * ex + ey * ey;
  }

  __device__ __forceinline__ static float stage_cost(const float (&x)[S], const float (&u)[U],
                                                     const float (&prev)[U], const float* c,
                                                     float max_cost) {
    const float pos = c[kPosWeight] * reach(x, c);
    const float vel = c[kVelWeight] * (x[1] * x[1] + x[3] * x[3]);
    float usq = 0.0f, dusq = 0.0f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      usq = usq + u[j] * u[j];
      const float du = u[j] - prev[j];
      dusq = dusq + du * du;
    }
    const float core = (pos + vel) + c[kCcWeight] * c[kR] * usq;
    return (core + c[kCcrcWeight] * dusq) - max_cost;
  }

  __device__ __forceinline__ static float terminal_cost(const float (&x)[S], const float* c) {
    return 10.0f * c[kPosWeight] * reach(x, c) + c[kVelWeight] * (x[1] * x[1] + x[3] * x[3]);
  }

  // The gradient of w * reach in (theta1, theta2) (ops/adjoints.py _arm2_pos_grad).
  __device__ __forceinline__ static void reach_grad(const float (&x)[S], const float* c, float w,
                                                    float& g1, float& g2) {
    const float l1 = c[kL1], l2 = c[kL2];
    const float s1 = sinf(x[0]), co1 = cosf(x[0]), s12 = sinf(x[0] + x[2]),
                c12 = cosf(x[0] + x[2]);
    const float ex = l1 * s1 + l2 * s12 - c[kTargetX];
    const float ey = -l1 * co1 - l2 * c12 - c[kTargetY];
    g2 = w * (ex * (l2 * c12) + ey * (l2 * s12));
    g1 = w * (ex * (l1 * co1) + ey * (l1 * s1)) + g2;
  }

  // ops/adjoints.py arm2_stage_vjp.
  __device__ __forceinline__ static void stage_cost_vjp(const float (&x)[S], const float (&u)[U],
                                                        const float (&prev)[U], const float* c,
                                                        float ct, float (&gx)[S], float (&gu)[U],
                                                        float (&gprev)[U]) {
    reach_grad(x, c, ct * (2.0f * c[kPosWeight]), gx[0], gx[2]);
    const float vw = 2.0f * c[kVelWeight];
    gx[1] = ct * vw * x[1];
    gx[3] = ct * vw * x[3];
    const float cc = 2.0f * c[kCcWeight] * c[kR];
    const float gcc[U] = {cc * u[0], cc * u[1]};
    control_grads<U>(u, prev, gcc, c[kCcrcWeight], ct, gu, gprev);
  }

  // ops/adjoints.py arm2_terminal_grad.
  __device__ __forceinline__ static void terminal_cost_grad(const float (&x)[S], const float* c,
                                                            float ct, float (&g)[S]) {
    reach_grad(x, c, ct * (20.0f * c[kPosWeight]), g[0], g[2]);
    const float vw = 2.0f * c[kVelWeight];
    g[1] = ct * vw * x[1];
    g[3] = ct * vw * x[3];
  }
};

// The ODE kernels' plant over dynamics without derivs_short: the dynamics'
// constants, then the cost's vector.  FastNormals (K3, K5 or K6 over a
// plant whose exact dynamics double as the fast ones) draws the fast
// counter normals.
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
  template <int N, int N0 = 0>
  __device__ __forceinline__ static void derivs_tangent(const float (&x)[S], const float (&u)[U],
                                                        const float* p, const float (&T)[S][N],
                                                        float (&d)[S], float (&dk)[S][N]) {
    Dyn::template derivs_tangent<N, N0>(x, u, p, T, d, dk);
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
// The fully-fused kernels' fast-normals instances over the point mass's
// exact dynamics.
struct PointmassFastNormalsPlant : PlantT<PointmassDynamics, PointmassCost, true> {};
struct PointmassObstacleFastNormalsPlant
    : PlantT<PointmassDynamics, PointmassObstacleCost, true> {};

// The quadrotor, car and arm plants (ops/kernels.py PLANT_IDS 8-17), each
// with its fast plant; the car/obstacles pair has one of its own, the car's
// fast dynamics differing from its exact ones.
struct Quadrotor2DPlant : PlantT<Quadrotor2DDynamicsT<false>, Quadrotor2DCost> {};
struct Quadrotor2DFastPlant : PlantT<Quadrotor2DDynamicsT<true>, Quadrotor2DCost> {};
struct Quadrotor3DPlant : PlantT<Quadrotor3DDynamicsT<false>, Quadrotor3DCost> {};
struct Quadrotor3DFastPlant : PlantT<Quadrotor3DDynamicsT<true>, Quadrotor3DCost> {};
struct CarPlant : PlantT<CarDynamicsT<false>, CarCost> {};
struct CarFastPlant : PlantT<CarDynamicsT<true>, CarCost> {};
struct CarObstaclePlant : PlantT<CarDynamicsT<false>, CarObstacleCost> {};
struct CarObstacleFastPlant : PlantT<CarDynamicsT<true>, CarObstacleCost> {};
struct Arm2Plant : PlantT<Arm2DynamicsT<false>, Arm2Cost> {};
struct Arm2FastPlant : PlantT<Arm2DynamicsT<true>, Arm2Cost> {};

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
