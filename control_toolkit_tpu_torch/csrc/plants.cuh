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

}  // namespace ctt
