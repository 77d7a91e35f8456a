// The MPPI cost of one rollout with its controls computed ahead of its
// steps, the body of control_toolkit_tpu/ops/pallas_mppi.py's
// rollout_cost_core (kernel1 :255, kernel1_ext :266, kernel1_cols :295)
// over a noise policy: K3's pass 1 (fused_mppi.cu) draws its noise from the
// counter PRNG (CounterNoise), K2 (mppi_cost.cu) and K4 (mppi_cost_cols.cu)
// read it from eps [P, U, K] (EpsNoise, below).
//
// For step h, with p0 <= p1 = p0+1 the inducing points that bracket h in the
// [P, H] interpolation matrix W, and e[p, j] the rollout's noise at point p
// and input j (Noise, below):
//   d_j   = W[p0,h] * e[p0,j] + W[p1,h] * e[p1,j]
//   u_j   = clamp(u_nom[h,j] + d_j, low[j], high[j])
//   corr += cc * ((c1*d_j)*d_j + (r*u_j)*d_j + (c3*u_j)*u_j)
//           with c1 = 0.5*(1-1/NU)*R, r = R, c3 = 0.5*R
// cost = (sum_h stage + terminal) / (H+1) + corr   (corr is not averaged)
// d's products and sum are each rounded (no FMA contraction), as torch
// computes them, so mppi_controls_plain (ops/mppi_cost.py) gives the
// controls these steps take, and K1 (cost_rollout.cu) over them gives these
// costs with cc = 0, bit for bit.  W is read from the matrix itself, so the
// kernels use the same float32 weights as the reference.
//
// What bounds its kernels on an H100: each rollout's serial H-step rk4
// chain, one warp a scheduler at the main path's K=16384 (K4 at B=128
// sessions of K=512 fills the SMs four times over, so there their
// throughput starts to bind); the bytes are the costs and, for K2 and K4,
// the noise.
// The design is K5's and K6's (cem_core.cuh) with the interpolated noise in
// place of CEM's draws:
// - The controls leave the chain.  Per chunk of kDrawControls / U steps, a
//   prologue walks the bracket (p0 and the two noise values carried from
//   chunk to chunk, one value drawn or read each time the bracket moves,
//   P*U a rollout), reads W and u_nom, writes each clipped control into the
//   thread's column of a [kDrawControls][kCemThreads] shared array and adds
//   the correction, which depends on the controls alone, in h order.
// - The chain is column_steps (cem_core.cuh): short_step.cuh's step, each
//   step's successor loaded while it runs.
// A rollout is a thread's, and a thread reads and writes only its own
// column: no barrier.
//
// A Noise policy is a callable (p, j) -> e[p, j], the scaled noise of the
// thread's rollout.
//
// The emit_terminal forms of K2 and K4 (pallas_mppi.py kernel1_ext_emit
// :277, kernel1_cols_emit :350) take the instance with Emit, which also
// hands the final state x_H out through x_end (S floats of the caller's
// registers); without Emit the body compiles as before.
#pragma once

#include "cem_core.cuh"

namespace ctt {

struct MppiCorr {
  float cc, c1, r, c3;
};

// The noise policy of K2 and K4: e[p, j] of rollout k read from one
// session's eps [P, U, K] (already scaled), the rollout index fastest, so
// a warp's 32 loads of one (p, j) are 128 contiguous bytes.
struct EpsNoise {
  const float* __restrict__ eps;
  int k, K, U;

  __device__ __forceinline__ float operator()(int p, int j) const {
    return __ldg(eps + static_cast<size_t>(p * U + j) * K + k);
  }
};

// The rollout from s0 [S] under u_nom [H, U], W [P, H], the packed
// parameters pvec [N] and the bounds low, high [U]; `column` as
// cem_rollout_cost's; where Emit, the terminal state to x_end [S].
template <class Plant, class Noise, bool Emit = false>
__device__ __forceinline__ float mppi_ahead_cost(
    const float* __restrict__ s0, const float* __restrict__ u_nom,
    const float* __restrict__ pvec, const float* __restrict__ W, const float* __restrict__ low,
    const float* __restrict__ high, const Noise& noise, int H, int P, const StepConsts& c,
    float max_cost, const MppiCorr& cc, float* column, float* x_end = nullptr) {
  constexpr int S = Plant::S, U = Plant::U;
  constexpr int kSteps = kDrawControls / U;
  static_assert(kSteps >= 1, "a chunk holds a step");
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  const typename Plant::Recips rc = Plant::recips(p);
  float lo[U], hi[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    lo[j] = __ldg(low + j);
    hi[j] = __ldg(high + j);
  }
  float x[S], prev[U], acc = 0.0f, corr = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = p[Plant::kUPrev + j];
  // The noise at the bracket's two inducing points p0 and p0+1.
  float e0[U], e1[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    e0[j] = noise(0, j);
    e1[j] = P > 1 ? noise(1, j) : 0.0f;
  }
  int p0 = 0;
  for (int h0 = 0; h0 < H; h0 += kSteps) {
    const int n = H - h0 < kSteps ? H - h0 : kSteps;
    for (int i = 0; i < n; ++i) {
      const int h = h0 + i;
      // The left bracket moves right where its weight has dropped to zero.
      while (p0 + 1 < P && __ldg(W + p0 * H + h) == 0.0f) {
        ++p0;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          e0[j] = e1[j];
          e1[j] = p0 + 1 < P ? noise(p0 + 1, j) : 0.0f;
        }
      }
      const bool two = p0 + 1 < P;
      const float w0 = __ldg(W + p0 * H + h);
      const float w1 = two ? __ldg(W + (p0 + 1) * H + h) : 0.0f;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        float d = __fmul_rn(w0, e0[j]);
        if (two) d = __fadd_rn(d, __fmul_rn(w1, e1[j]));
        const float u = fminf(fmaxf(__ldg(u_nom + h * U + j) + d, lo[j]), hi[j]);
        column[(i * U + j) * kCemThreads] = u;
        corr = corr + cc.cc * ((cc.c1 * d * d + cc.r * u * d) + cc.c3 * u * u);
      }
    }
    column_steps<Plant>(x, prev, acc, p, rc, c, max_cost, column, n);
  }
  if constexpr (Emit) {
#pragma unroll
    for (int i = 0; i < S; ++i) x_end[i] = x[i];
  }
  return (acc + Plant::terminal_cost(x, p)) / static_cast<float>(H + 1) + corr;
}

}  // namespace ctt
