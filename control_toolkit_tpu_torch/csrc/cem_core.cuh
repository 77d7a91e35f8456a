// The fully-fused CEM rollout shared by K5 (fused_cem.cu, one session) and
// K6 (fused_cem_cols.cu, B sessions): the controls drawn from the counter
// PRNG, clipped, rolled out and scored (control_toolkit_tpu/ops/
// pallas_cem.py, the bodies of build_fused_cem and build_fused_cem_cols).
// The two kernels differ only in their counter layouts and in which rows a
// rollout reads.
//
// The control at step h and input j is
//   u = clamp(mue[h,j] + std[h,j] * z, low[j], high[j]),
//   z = counter_normal(base + j*jstride + h*hstride)
// in uint32 arithmetic (over the fast plant, CartpoleFastPlant, the fast
// normal: the JAX fast_sampling form, which the regenerations draw with
// fast=True); each kernel gives its own counter layout as
// (base, jstride, hstride).  mue + std*z is rounded twice, as torch and XLA
// compute it (no FMA contraction), so the rows that the torch regeneration
// draws again are the controls the kernel scored.
//
// What bounds it on an H100: each rollout's serial H-step rk4 chain, one
// warp a scheduler or little more at the main paths' sizes, so nothing
// hides a step's latency; the bytes are the costs.  The body shortens the
// chain:
// - The draws leave it.  Before its steps, a rollout draws its controls
//   (two splitmix32 hashes, logf, sqrtf and cosf each) into its column of
//   shared memory, kDrawControls at a time: independent draws, unrolled,
//   issue back to back; then each step reads its control, the next one
//   loaded while the step runs.
// - The step is short_step.cuh's (derivs_short: one sincosf and one
//   division a plant evaluation), K1's step too, so the costs of the
//   controls that the torch regeneration draws again, scored by K1, are
//   these costs bit for bit.
// A rollout is a thread's, and a thread reads and writes only its own
// column: no barrier.  (Two or four lanes a rollout, splitting its draws,
// were 3% and 34% slower for K5 at K=16384: PERF.md.)
#pragma once

#include "counter_prng.cuh"
#include "short_step.cuh"

namespace ctt {

constexpr int kCemThreads = 128;   // threads a K5 or K6 block
constexpr int kDrawControls = 64;  // controls a rollout draws ahead, per chunk of steps

// The clipped control of one counter: clamp(mue + std * z, lo, hi), the
// sum and the product each rounded (no FMA contraction); Fast: z the fast
// normal (the fast plant's, JAX's fast_sampling).
template <bool Fast>
__device__ __forceinline__ float cem_control(uint32_t counter, float mue, float std_dev, float lo,
                                             float hi) {
  const float v = __fadd_rn(mue, __fmul_rn(std_dev, counter_normal<Fast>(counter)));
  return fminf(fmaxf(v, lo), hi);
}

// n short steps of a rollout (x, prev, acc) over the controls of the
// thread's `column` of a [kDrawControls][kCemThreads] shared array (control
// i, input j at column[(i * U + j) * kCemThreads]), each step's successor
// loaded while it runs: the chain of K5, K6 and K3's pass 1
// (mppi_ahead.cuh).
template <class Plant>
__device__ __forceinline__ void column_steps(float (&x)[Plant::S], float (&prev)[Plant::U],
                                             float& acc, const float* p,
                                             const typename Plant::Recips& rc,
                                             const StepConsts& c, float max_cost,
                                             const float* column, int n) {
  constexpr int U = Plant::U;
  float u_next[U];
#pragma unroll
  for (int j = 0; j < U; ++j) u_next[j] = column[j * kCemThreads];
  for (int i = 0; i < n; ++i) {
    float u[U];
    const int ahead = i + 1 < n ? i + 1 : i;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = u_next[j];
      u_next[j] = column[(ahead * U + j) * kCemThreads];
    }
    short_step<Plant>(x, u, prev, acc, p, rc, c, max_cost);
  }
}

// The cost (sum_h stage + terminal) / (H+1) of the rollout from s0 [S]
// under the controls of counters (base, jstride, hstride) over the
// distribution mue, std [H, U], the packed parameters pvec [N] and the
// bounds low, high [U].  `column` is the thread's column of a
// [kDrawControls][kCemThreads] shared array: element i of it lies at
// column[i * kCemThreads].
template <class Plant>
__device__ __forceinline__ float cem_rollout_cost(
    const float* __restrict__ s0, const float* __restrict__ mue,
    const float* __restrict__ std_dev, const float* __restrict__ pvec,
    const float* __restrict__ low, const float* __restrict__ high, uint32_t base, uint32_t jstride,
    uint32_t hstride, int H, const StepConsts& c, float max_cost, float* column) {
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
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = p[Plant::kUPrev + j];
  for (int h0 = 0; h0 < H; h0 += kSteps) {
    const int n = H - h0 < kSteps ? H - h0 : kSteps;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int h = h0 + i;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const uint32_t counter =
            base + static_cast<uint32_t>(j) * jstride + static_cast<uint32_t>(h) * hstride;
        column[(i * U + j) * kCemThreads] = cem_control<Plant::kFast>(
            counter, __ldg(mue + h * U + j), __ldg(std_dev + h * U + j), lo[j], hi[j]);
      }
    }
    column_steps<Plant>(x, prev, acc, p, rc, c, max_cost, column, n);
  }
  return (acc + Plant::terminal_cost(x, p)) / static_cast<float>(H + 1);
}

}  // namespace ctt
