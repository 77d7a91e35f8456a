// The sparse-GP core shared by K14 (GP rollout + cost) and K10 (its cost
// and gradient), gp_rollout.cu.  It replaces the Pallas kernels' GP step
// (control_toolkit_tpu/ops/pallas_neural.py:697-709 and
// ops/pallas_grad.py:547-559), which ran the per-step [M, tile] distance
// and RBF blocks as two MXU matmuls in VMEM.
//
// The step, over the precomputed operands of ops/gp_rollout.py
// flatten_gp_weights (D = S + U inputs, M inducing points):
//   an = ([x, u] - in_mean) * inv_in,     an2 = sum_d an_d^2
//   g_m = Zs_m . an,   d2_m = max(an2 - 2 g_m + zn2_m, 0)
//   k_m = var * exp(-0.5 d2_m)
//   x' = x + (sum_m alphaT[:, m] k_m) * out_std + out_mean
// (the JAX formula for d2, not the expanded sum of (an - Zs_m)^2, so the
// kernel and the plain version round alike).
//
// Design: a block stages the inducing points into dynamic shared memory as
// M rows of kRow floats, [Zs_m (D), zn2_m, zeros to a multiple of 4,
// alphaT[:, m] (S), zeros], so a thread reads a row as float4s.  The
// affine input transform and the output scaling sit in registers.  A
// rollout's step runs on L lanes of one warp (L a template parameter; K14
// takes L = 1, one thread a rollout, K10 L = 4..32): lane r of the L
// takes m = r, r + L, .. (an M that is not a multiple of L leaves the last
// lanes one point fewer) and keeps its own partial sums, which lane_sum
// adds over the L lanes with an __shfl_xor_sync butterfly.  A butterfly
// leaves the same bits on every lane (each round adds two values that
// commute), so the L lanes go on with one identical x, lam and cotangent.
// The host side (gp_smem_bytes) refuses an M whose rows exceed a block's
// shared memory; the entry points then return cudaErrorInvalidValue.
#pragma once

#include <cuda_runtime.h>

#include "neural_core.cuh"

namespace ctt {

// The GP as the wrapper passes it (ops/kernels.py GPArgs, GP_OPERANDS).
struct GPArgs {
  int M;
  const float* Zs;        // [M, D]
  const float* zn2;       // [M]
  const float* alphaT;    // [S, M]
  const float* in_mean;   // [D]
  const float* inv_in;    // [D]
  const float* out_mean;  // [S]
  const float* out_std;   // [S]
  const float* var;       // [] (one float)
};

template <int S, int U>
struct GPRow {
  static constexpr int D = S + U;
  static constexpr int kZ = (D + 1 + 3) / 4 * 4;        // Zs_m, zn2_m, padding
  static constexpr int kRow = kZ + (S + 3) / 4 * 4;     // then alphaT[:, m], padding
};

// Dynamic shared memory of a block for M inducing points, or -1 where the
// kernels refuse M.
template <int S, int U>
inline long gp_smem_bytes(int M) {
  const long bytes = 4L * M * GPRow<S, U>::kRow;
  return M >= 1 && bytes <= kMaxSmem ? bytes : -1;
}

// Stage the M rows; the caller then synchronises the block.
template <int S, int U>
__device__ __forceinline__ void stage_gp(float* sm, const GPArgs& gp) {
  using R = GPRow<S, U>;
  const int len = gp.M * R::kRow;
  for (int idx = threadIdx.x; idx < len; idx += blockDim.x) {
    const int m = idx / R::kRow, j = idx - m * R::kRow;
    float v = 0.0f;
    if (j < R::D) {
      v = __ldg(gp.Zs + static_cast<size_t>(m) * R::D + j);
    } else if (j == R::D) {
      v = __ldg(gp.zn2 + m);
    } else if (j >= R::kZ && j - R::kZ < S) {
      v = __ldg(gp.alphaT + static_cast<size_t>(j - R::kZ) * gp.M + m);
    }
    sm[idx] = v;
  }
}

// A thread's copy of the GP's small operands.
template <int S, int U>
struct GPConsts {
  float in_mean[S + U], inv_in[S + U], out_mean[S], out_std[S], var;

  __device__ __forceinline__ void load(const GPArgs& gp) {
#pragma unroll
    for (int d = 0; d < S + U; ++d) {
      in_mean[d] = __ldg(gp.in_mean + d);
      inv_in[d] = __ldg(gp.inv_in + d);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      out_mean[s] = __ldg(gp.out_mean + s);
      out_std[s] = __ldg(gp.out_std + s);
    }
    var = __ldg(gp.var);
  }
};

// Row m of the staged GP, in registers.
template <int S, int U>
__device__ __forceinline__ void gp_row(const float* sm, int m, float (&r)[GPRow<S, U>::kRow]) {
  const float4* row = reinterpret_cast<const float4*>(sm + m * GPRow<S, U>::kRow);
#pragma unroll
  for (int v = 0; v < GPRow<S, U>::kRow / 4; ++v) {
    const float4 w = row[v];
    r[4 * v + 0] = w.x;
    r[4 * v + 1] = w.y;
    r[4 * v + 2] = w.z;
    r[4 * v + 3] = w.w;
  }
}

// an = ([x, u] - in_mean) * inv_in and its squared norm.
template <int S, int U>
__device__ __forceinline__ float gp_input(const GPConsts<S, U>& g, const float (&x)[S],
                                          const float (&u)[U], float (&an)[S + U]) {
  float an2 = 0.0f;
#pragma unroll
  for (int d = 0; d < S + U; ++d) {
    const float a = d < S ? x[d] : u[d - S];
    an[d] = (a - g.in_mean[d]) * g.inv_in[d];
    an2 = an2 + an[d] * an[d];
  }
  return an2;
}

// d2_m before the clip: an2 - 2 g_m + zn2_m.
template <int S, int U>
__device__ __forceinline__ float gp_d2(const float (&r)[GPRow<S, U>::kRow],
                                       const float (&an)[S + U], float an2) {
  float gdot = 0.0f;
#pragma unroll
  for (int d = 0; d < S + U; ++d) gdot = fmaf(r[d], an[d], gdot);
  return (an2 - 2.0f * gdot) + r[S + U];
}

// v[i] summed over the L lanes of this lane's rollout, the sum on every
// lane: log2 L rounds, each adding the value of the lane whose r differs in
// one bit.  A rollout's lanes lie Stride apart in the warp (lane r at
// r * Stride from its first).  All 32 lanes of the warp take part.
template <int L, int N, int Stride = 1>
__device__ __forceinline__ void lane_sum(float (&v)[N]) {
#pragma unroll
  for (int mask = 1; mask < L; mask <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = v[i] + __shfl_xor_sync(0xffffffffu, v[i], mask * Stride);
    }
  }
}

// One GP transition of x (GPPredictor.single_step) on lane r of the
// rollout's L lanes, Stride apart in the warp.
template <int S, int U, int L, int Stride = 1>
__device__ __forceinline__ void gp_step(const float* sm, int M, int r, const GPConsts<S, U>& g,
                                        float (&x)[S], const float (&u)[U]) {
  using R = GPRow<S, U>;
  float an[R::D], acc[S];
  const float an2 = gp_input<S, U>(g, x, u, an);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0f;
  for (int m = r; m < M; m += L) {
    float row[R::kRow];
    gp_row<S, U>(sm, m, row);
    const float d2 = fmaxf(gp_d2<S, U>(row, an, an2), 0.0f);
    const float km = g.var * expf(-0.5f * d2);
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = fmaf(row[R::kZ + s], km, acc[s]);
  }
  lane_sum<L, S, Stride>(acc);
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = x[s] + (acc[s] * g.out_std[s] + g.out_mean[s]);
}

// lam^T d x' / d(x, u) for gp_step at (x, u) (ops/adjoints.py gp_step_vjp)
// on lane r of the rollout's L lanes: lo = lam * out_std; per m, k_m
// recomputed, kbar_m = lo . alphaT[:, m], d2bar_m = -0.5 kbar_m k_m times
// the clip's derivative (1 above, 0 below, 1/2 at a tie), anbar +=
// d2bar_m (2 an - 2 Zs_m), the lane's partial sums added by lane_sum; then
// abar = anbar * inv_in, dx = lam + abar[:S], du = abar[S:].
template <int S, int U, int L>
__device__ __forceinline__ void gp_step_vjp(const float* sm, int M, int r,
                                            const GPConsts<S, U>& g, const float (&x)[S],
                                            const float (&u)[U], const float (&lam)[S],
                                            float (&dx)[S], float (&du)[U]) {
  using R = GPRow<S, U>;
  float an[R::D], anbar[R::D], lo[S];
  const float an2 = gp_input<S, U>(g, x, u, an);
#pragma unroll
  for (int s = 0; s < S; ++s) lo[s] = lam[s] * g.out_std[s];
#pragma unroll
  for (int d = 0; d < R::D; ++d) anbar[d] = 0.0f;
  for (int m = r; m < M; m += L) {
    float row[R::kRow];
    gp_row<S, U>(sm, m, row);
    const float raw = gp_d2<S, U>(row, an, an2);
    const float km = g.var * expf(-0.5f * fmaxf(raw, 0.0f));
    float kbar = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) kbar = fmaf(lo[s], row[R::kZ + s], kbar);
    const float clip = raw > 0.0f ? 1.0f : (raw == 0.0f ? 0.5f : 0.0f);
    const float d2bar = -0.5f * kbar * km * clip;
#pragma unroll
    for (int d = 0; d < R::D; ++d) anbar[d] = fmaf(d2bar, 2.0f * an[d] - 2.0f * row[d], anbar[d]);
  }
  lane_sum<L, R::D>(anbar);
#pragma unroll
  for (int s = 0; s < S; ++s) dx[s] = lam[s] + anbar[s] * g.inv_in[s];
#pragma unroll
  for (int j = 0; j < U; ++j) du[j] = anbar[S + j] * g.inv_in[S + j];
}

}  // namespace ctt
