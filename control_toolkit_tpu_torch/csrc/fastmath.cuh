// Polynomial sin, cos and log: the device twin of ops/fastmath.py, which
// copies control_toolkit_tpu/ops/fastmath.py.  The fast plants
// (plants.cuh: CartpolePlantT<true>, PendulumDynamicsT<true>,
// AcrobotDynamicsT<true>) take their trig here, and the kernels over them
// draw the fast counter normals (counter_prng.cuh counter_normal<true>)
// from fast_log and fast_cos.
//
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), so nvcc contracts nothing into an FMA: the values are the
// ones torch computes from the same float32 inputs, one operation a
// kernel, and the card's regenerations of the fast normals (ops/
// fused_cem.py regen_controls, fused_cem_cols.py regen_cols) draw the
// kernels' normals bit for bit.  The range reduction rounds half to even
// (rintf), as torch.round and jnp.round do; roundf would round half away
// from zero.  The constants are the Python module's doubles rounded to
// float, as a Python float is when it meets a float32 tensor.
//
// fast_sincos_d adds the derivatives that jax.vjp takes through
// fast_sincos: round has a zero gradient, so dr/dx = 1 and they are the
// polynomials' own, S'(r) and C'(r) (as ndcos = -C'(r)), not fast_cos and
// -fast_sin.
//
// On an H100 sincosf of a small argument is already a short sequence (the
// fast path of its range reduction), so the polynomials need not be
// faster there; the TPU's 1.6x (the Python module's note) says nothing of
// this card (PERF.md).
#pragma once

#include <cuda_runtime.h>

namespace ctt {

// The coefficients (the Python module's, as doubles; the derivatives'
// multiples taken in double too, as ops/fastmath.py takes them), each
// rounded to float once.  Scalars only: a constexpr array at namespace
// scope cannot be read from device code.
namespace fastmath {
constexpr double kTwoPi = 6.283185307179586;
constexpr float kTwoPiF = static_cast<float>(kTwoPi);
constexpr float kInvTwoPiF = static_cast<float>(1.0 / kTwoPi);
constexpr double S0 = 0.9999791148945326, S1 = -0.16662401538302676,
                 S2 = 0.008308849931229436, S3 = -0.00019263169952705723,
                 S4 = 2.14704961562231e-06;
constexpr double C0 = 0.9999992107409235, C1 = -0.49999421315021114,
                 C2 = 0.04165977758578502, C3 = -0.0013858789204321562,
                 C4 = 2.420293205122177e-05, C5 = -2.1972921877546382e-07;
constexpr double L0 = 2.1237408918309273e-06, L1 = 1.4424753148220764,
                 L2 = -0.7175578724221764, L3 = 0.45552708806115005,
                 L4 = -0.2746232576172888, L5 = 0.11929823770627786,
                 L6 = -0.02512320328611391;
constexpr float kLn2F = static_cast<float>(0.6931471805599453);

// c0 + x * c1, rounded twice.
__device__ __forceinline__ float madd(double c0, float x, float c1) {
  return __fadd_rn(static_cast<float>(c0), __fmul_rn(x, c1));
}

// sin: r * (S0 + r2 * (S1 + r2 * (S2 + r2 * (S3 + r2 * S4)))) without the r.
__device__ __forceinline__ float sin_poly(float r2) {
  return madd(S0, r2, madd(S1, r2, madd(S2, r2, madd(S3, r2, static_cast<float>(S4)))));
}
__device__ __forceinline__ float cos_poly(float r2) {
  return madd(C0, r2,
              madd(C1, r2, madd(C2, r2, madd(C3, r2, madd(C4, r2, static_cast<float>(C5))))));
}
// S'(r) = S0 + 3 S1 r2 + 5 S2 r2^2 + 7 S3 r2^3 + 9 S4 r2^4.
__device__ __forceinline__ float dsin_poly(float r2) {
  return madd(S0, r2,
              madd(3.0 * S1, r2, madd(5.0 * S2, r2, madd(7.0 * S3, r2,
                                                          static_cast<float>(9.0 * S4)))));
}
// -C'(r) / r = -2 C1 - 4 C2 r2 - 6 C3 r2^2 - 8 C4 r2^3 - 10 C5 r2^4.
__device__ __forceinline__ float ndcos_poly(float r2) {
  return madd(-2.0 * C1, r2,
              madd(-4.0 * C2, r2, madd(-6.0 * C3, r2, madd(-8.0 * C4, r2,
                                                            static_cast<float>(-10.0 * C5)))));
}
__device__ __forceinline__ float log2_poly(float t) {
  return madd(L0, t, madd(L1, t, madd(L2, t, madd(L3, t, madd(L4, t, madd(L5, t,
                                                                      static_cast<float>(L6)))))));
}
}  // namespace fastmath

// x - 2 pi round(x / 2 pi), round half to even.
__device__ __forceinline__ float fast_reduce(float x) {
  using namespace fastmath;
  return __fsub_rn(x, __fmul_rn(kTwoPiF, rintf(__fmul_rn(x, kInvTwoPiF))));
}

__device__ __forceinline__ void fast_sincos(float x, float& s, float& c) {
  const float r = fast_reduce(x), r2 = __fmul_rn(r, r);
  s = __fmul_rn(r, fastmath::sin_poly(r2));
  c = fastmath::cos_poly(r2);
}

__device__ __forceinline__ float fast_cos(float x) {
  const float r = fast_reduce(x);
  return fastmath::cos_poly(__fmul_rn(r, r));
}

__device__ __forceinline__ float fast_sin(float x) {
  const float r = fast_reduce(x);
  return __fmul_rn(r, fastmath::sin_poly(__fmul_rn(r, r)));
}

// The values, dsin = S'(r) and ndcos = -C'(r): ops/fastmath.py
// fast_sincos_d.
__device__ __forceinline__ void fast_sincos_d(float x, float& s, float& c, float& dsin,
                                              float& ndcos) {
  const float r = fast_reduce(x), r2 = __fmul_rn(r, r);
  s = __fmul_rn(r, fastmath::sin_poly(r2));
  c = fastmath::cos_poly(r2);
  dsin = fastmath::dsin_poly(r2);
  ndcos = __fmul_rn(r, fastmath::ndcos_poly(r2));
}

// ln x = ln2 (e + log2 m) for a positive normal x = m 2^e, m in [1, 2),
// e and m read from the bits.
__device__ __forceinline__ float fast_log(float x) {
  const int bits = __float_as_int(x);
  const int e = static_cast<int>(static_cast<unsigned>(bits) >> 23) - 127;
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F800000);
  return __fmul_rn(fastmath::kLn2F,
                   __fadd_rn(static_cast<float>(e), fastmath::log2_poly(__fsub_rn(m, 1.0f))));
}

}  // namespace ctt
