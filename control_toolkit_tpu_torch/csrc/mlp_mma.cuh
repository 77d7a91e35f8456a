// The warp-level tensor-core MLP of the gradient kernels K8 (MLP rollout
// cost and its gradient, neural_grad_rollout.cu) and K9 (the same under the
// residual "ODE+res" model, residual_rollout.cu).  It replaces the Pallas
// kernels' row-MLP in control_toolkit_tpu/ops/pallas_grad.py
// (_make_fwd_bwd_kernel), which ran each layer as one MXU matmul over a
// [features, tile] slab in VMEM and got the transposed layers from jax.vjp.
//
// Design, for Hopper's mma.sync:
// - A warp owns 16 rollouts, one m16 tile.  Each layer is a chain of
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 over
//   [16, d_in] x [d_in, d_out], its widths padded with zeros to multiples of
//   8 ([x, u] of S+U = 5 to k = 8, the output S = 4 to n = 8), with FP32
//   accumulators.  Why mma.sync and not wgmma: the products are 16-64 wide
//   and chained through a nonlinearity at every layer, so a layer's output
//   is the next one's input within a few hundred cycles; wgmma's 64-row
//   warpgroup tiles would take 64 rollouts to a warpgroup (a quarter of the
//   warps at K=16384) and its operands through shared memory.
// - 3xTF32 keeps the products FP32-accurate: each operand is split as
//   a = a_hi + a_lo, a_hi = cvt.rna.tf32(a), a_lo = cvt.rna.tf32(a - a_hi),
//   and each k-block accumulates a_lo.b_hi, then a_hi.b_lo, then a_hi.b_hi
//   into the FP32 accumulator (a_lo.b_lo, ~2^-22 relative, is dropped).
//   The weights are split once, when a block stages them, and stored as
//   {b0_hi, b1_hi, b0_lo, b1_lo} per lane in the order of the B fragments,
//   so that each lane's fragment is one conflict-free 16-byte load; the
//   activations are split in registers, once per k-block.  Each of the
//   three products runs over all of a layer's output tiles before the
//   next, so a tile's next mma waits on its last by as many issues as
//   there are tiles; an output of one tile (the output layers, S and S+U
//   wide) gives each k-block a partial sum of its own, added in k order at
//   the end, in place of one chain of 3 kt dependent mma.
// - Activations stay in registers between layers: the C fragment of layer
//   l (lane (g, t) = (lane / 4, lane % 4) holds rows g and g+8, columns 2t
//   and 2t+1 of each 8-column tile) is exactly the A fragment of layer l+1
//   (rows g and g+8, A columns t and t+4), because every layer's weight
//   rows are staged with their k index permuted inside each 8-block: A
//   column t holds true column 2t and A column t+4 holds 2t+1.  No shuffle
//   and no shared-memory round trip between layers; bias and tanh are
//   applied on the fragment.  The transposed weights for the backward's
//   g @ W^T are staged once, permuted the same way.
// - Layers up to kRegTiles tiles (64 columns) wide keep their activations
//   in registers; a wider one goes through a per-warp shared-memory arena
//   in the same fragment order (each lane reads back only what it wrote),
//   computed kRegTiles output tiles at a time.
// - The backward re-runs the forward of step h (storing the activations of
//   all H steps would take K*H*sum(widths)*4 bytes, 420 MB for mlp-64-64 at
//   K=16384, H=50); the re-run keeps each hidden layer's output in a
//   per-warp stash, in fragment order, for tanh' = 1 - a^2, which the
//   transposed layer applies to its A fragment as it splits it.
// - Scalar work runs one rollout per lane: lanes l and l+16 both own
//   rollout l and repeat its norms, cost and (K9) integrator.  A per-warp
//   [16, 8] tile moves [x, u] from the lane layout to the fragment layout
//   and the output back, with __syncwarp around it and no block barrier.
// - Rows past K (ragged K, or K < 16) repeat rollout K-1 and write
//   nothing; a warp with no row below K returns after the block's staging.
// The host side (plan_mma) lays out the staged net and the per-warp
// regions and refuses what the network kernels refuse (not an MLP, more
// than kMaxLayers layers, widths that do not chain, a block beyond sm_90's
// shared memory); the entry points then return cudaErrorInvalidValue.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "neural_core.cuh"
#include "value_mlp.cuh"

namespace ctt {

constexpr int kMmaWarps = 8;                 // warps per block, at most
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16;                 // rollouts per warp: one m16 tile
constexpr int kRegTiles = 8;                 // 8-column tiles an activation keeps in registers
constexpr int kTileFloats = 128;             // one fragment tile: 32 lanes x 4 floats
// Columns of a value_spec form's value activations: one a rollout of a
// block of kMmaWarps warps.
constexpr int kValueCols = kMmaWarps * kMmaRows;

// Offsets (floats) of the staged net and of each warp's region.
struct MmaLayout {
  int kt[kMaxLayers], nt[kMaxLayers];  // layer l: 8-blocks of its input, tiles of its output
  int fw[kMaxLayers], tw[kMaxLayers];  // forward and transposed (or -1) B fragments, hi/lo split
  int bias[kMaxLayers];                // padded with zeros to 8 * nt
  int norm[4];                         // in mean, in std, out mean, out std; -1
  int net_floats;
  // In a warp's region: the stash of hidden layer l's outputs, two arena
  // buffers of arena_tiles tiles each, and the lane tiles in and out.
  int stash[kMaxLayers], arena, arena_tiles, io;
  int warp_floats;
  int warps;  // per block: kMmaWarps, or fewer where the regions would not fit
};

// Lay out the staged net of `a` for a plant of S states and U controls:
// each layer's forward B fragments and (`transposed`) its transposed ones,
// else tw = -1, its bias and the norms.  Returns its floats, or -1 for a
// net the tensor-core kernels refuse.
inline int plan_mma_net(const NetArgs& a, int S, int U, bool transposed, MmaLayout& L) {
  int off = 0;
  auto take = [&off](int n) { const int o = off; off += pad_to(n, 4); return o; };
  const int n = a.n_layers;
  if (a.kind != kNetMLP || n < 1 || n > kMaxLayers || S + U > 8 || a.dims[0] != S + U ||
      a.dims[n] != S) {
    return -1;
  }
  if ((a.norm_in_mean == nullptr) != (a.norm_in_std == nullptr) ||
      (a.norm_out_mean == nullptr) != (a.norm_out_std == nullptr)) {
    return -1;
  }
  for (int l = 0; l < n; ++l) {
    if (a.dims[l + 1] < 1) return -1;
    L.kt[l] = pad_to(a.dims[l], 8) / 8;
    L.nt[l] = pad_to(a.dims[l + 1], 8) / 8;
    L.fw[l] = take(L.kt[l] * L.nt[l] * kTileFloats);
    L.tw[l] = transposed ? take(L.kt[l] * L.nt[l] * kTileFloats) : -1;
    L.bias[l] = take(8 * L.nt[l]);
  }
  for (int i = 0; i < 4; ++i) L.norm[i] = -1;
  if (a.norm_in_mean) {
    L.norm[0] = take(S + U);
    L.norm[1] = take(S + U);
  }
  if (a.norm_out_mean) {
    L.norm[2] = take(S);
    L.norm[3] = take(S);
  }
  L.net_floats = off;
  return off;
}

// Lay out `a` for a plant of S states and U controls; returns the block's
// dynamic shared memory in bytes, or -1 for a net the kernels refuse.  A
// block takes kMmaWarps warps, or the most of 4, 2 and 1 whose regions fit
// beside the net (a net wider than 64 or deeper than a few layers) and
// `extra_bytes` after them (a value_spec form's value net).
inline long plan_mma(const NetArgs& a, int S, int U, MmaLayout& L, long extra_bytes = 0) {
  if (plan_mma_net(a, S, U, true, L) < 0) return -1;
  int warp = 0, widest = 0;
  const int n = a.n_layers;
  for (int l = 0; l < n; ++l) {
    if (l < n - 1) {
      L.stash[l] = warp;
      warp += L.nt[l] * kTileFloats;
    }
    widest = L.nt[l] > widest ? L.nt[l] : widest;
  }
  L.arena_tiles = widest > kRegTiles ? widest : 0;
  L.arena = warp;
  warp += 2 * L.arena_tiles * kTileFloats;
  L.io = warp;
  warp += 2 * kMmaRows * 8;
  L.warp_floats = warp;
  for (L.warps = kMmaWarps; L.warps >= 1; L.warps /= 2) {
    const long bytes = 4L * (L.net_floats + static_cast<long>(L.warps) * warp) + extra_bytes;
    if (bytes <= kMaxSmem) return bytes;
  }
  return -1;
}

// ---- tf32 and mma ----------------------------------------------------------

// x rounded to tf32 (nearest, ties away from zero), its 13 low bits zero.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo in tf32; x - hi is exact in FP32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a b over one m16n8k8 tile, FP32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (split) of a C-layout fragment c = (row g: cols 2t, 2t+1;
// row g+8: cols 2t, 2t+1) under the permuted k order: a0 = (g, t) = c0,
// a1 = (g+8, t) = c2, a2 = (g, t+4) = c1, a3 = (g+8, t+4) = c3.
__device__ __forceinline__ void a_fragment(const float (&c)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// ---- staging ---------------------------------------------------------------

// One B fragment pair, split: {hi(w0), hi(w1), lo(w0), lo(w1)}.
__device__ __forceinline__ float4 split_pair(float w0, float w1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(w0, h0, l0);
  split_tf32(w1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                     __uint_as_float(l1));
}

// Stage the whole net; the caller then synchronises the block.  Fragment
// (kb, j) of a layer of NT output tiles is at [(kb * NT + j) * 32 + lane]
// (float4s): lane (g, t) holds B rows 8kb + 2t and 8kb + 2t + 1 (the
// permuted k order) of column 8j + g.  Forward: B = W [d_in, d_out];
// transposed (where the layout has them, tw >= 0): B = W^T [d_out, d_in],
// kt and nt swapped.  `member` picks one net of a stacked ensemble (the
// member-block forms of K11 and K8): every tensor has a leading member
// axis, so member m's leaf lies m times the leaf's size past a's pointer.
__device__ __forceinline__ void stage_mma_net(float* sm, const NetArgs& a, const MmaLayout& L,
                                              int S, int U, int member = 0) {
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1], KT = L.kt[l], NT = L.nt[l];
    const float* __restrict__ W = a.w[l] + static_cast<size_t>(member) * din * dout;
    const int len = KT * NT * 32;
    float4* fw = reinterpret_cast<float4*>(sm + L.fw[l]);
    float4* tw = L.tw[l] >= 0 ? reinterpret_cast<float4*>(sm + L.tw[l]) : nullptr;
    for (int idx = threadIdx.x; idx < len; idx += blockDim.x) {
      const int lane = idx & 31, f = idx >> 5, g = lane >> 2, t = lane & 3;
      int kb = f / NT, j = f - kb * NT;  // forward: k over din, n over dout
      int k = 8 * kb + 2 * t, c = 8 * j + g;
      fw[idx] = split_pair(k < din && c < dout ? __ldg(W + k * dout + c) : 0.0f,
                           k + 1 < din && c < dout ? __ldg(W + (k + 1) * dout + c) : 0.0f);
      if (!tw) continue;
      kb = f / KT;  // transposed: k over dout, n over din
      j = f - kb * KT;
      k = 8 * kb + 2 * t;
      c = 8 * j + g;
      tw[idx] = split_pair(k < dout && c < din ? __ldg(W + c * dout + k) : 0.0f,
                           k + 1 < dout && c < din ? __ldg(W + c * dout + k + 1) : 0.0f);
    }
    stage_rows(sm + L.bias[l], a.b[l] + static_cast<size_t>(member) * dout, 1, 1, dout, 8 * NT);
  }
  const float* norms[4] = {a.norm_in_mean, a.norm_in_std, a.norm_out_mean, a.norm_out_std};
  for (int i = 0; i < 4; ++i) {
    const int n = i < 2 ? S + U : S;
    if (L.norm[i] >= 0) {
      stage_rows(sm + L.norm[i], norms[i] + static_cast<size_t>(member) * n, 1, 1, n, n);
    }
  }
}

// ---- layers ----------------------------------------------------------------

// acc[first + j] += A B(j) for j < nj in 3xTF32, B(j) = {b0_hi, b1_hi,
// b0_lo, b1_lo} at b[j * 32]: a_lo b_hi, then a_hi b_lo, then a_hi b_hi,
// each product over all the tiles before the next, so that a tile's next
// mma waits on its last by nj issues, not one.
__device__ __forceinline__ void mma3_tiles(float (&acc)[kRegTiles][4], int first, int nj,
                                           const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                           const float4* b) {
  float4 f[kRegTiles];
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
    if (j == nj) break;  // a branch out, not predicated-off work
    f[j] = b[j * 32];
  }
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
    if (j == nj) break;
    mma_tf32(acc[first + j], lo, __float_as_uint(f[j].x), __float_as_uint(f[j].y));
  }
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
    if (j == nj) break;
    mma_tf32(acc[first + j], hi, __float_as_uint(f[j].z), __float_as_uint(f[j].w));
  }
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
    if (j == nj) break;
    mma_tf32(acc[first + j], hi, __float_as_uint(f[j].x), __float_as_uint(f[j].y));
  }
}

// The split A fragment of k-block kb: the activation's C fragment c, times
// 1 - s^2 of the stashed fragment `prime` where given (tanh').
__device__ __forceinline__ void a_block(float (&c)[4], const float4* prime, int kb,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  if (prime) {
    const float4 s = prime[kb * 32];
    c[0] = c[0] * (1.0f - s.x * s.x);
    c[1] = c[1] * (1.0f - s.y * s.y);
    c[2] = c[2] * (1.0f - s.z * s.z);
    c[3] = c[3] * (1.0f - s.w * s.w);
  }
  a_fragment(c, hi, lo);
}

// acc[j] = sum over kb < kt of A(kb) B(kb, j0 + j) for j < nj: A(kb) is the
// activation's fragment kb, from registers `rin` or (kSmemIn) from the
// lane's arena slots `ain`, times tanh' of `prime` where given; B points
// at the layer's fragments plus the lane.  A single output tile from
// registers (the output layers, S and S+U wide) takes each k-block into an
// accumulator of its own, summed in k order after the last: eight chains
// of three mma in place of one of 3 kt.
template <bool kSmemIn>
__device__ __forceinline__ void mma_tiles(const float (&rin)[kRegTiles][4], const float4* ain,
                                          const float4* prime, int kt, const float4* B, int NT,
                                          int j0, int nj, float (&acc)[kRegTiles][4]) {
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
  }
  uint32_t hi[4], lo[4];
  if constexpr (kSmemIn) {
    for (int kb = 0; kb < kt; ++kb) {
      const float4 v = ain[kb * 32];
      float c[4] = {v.x, v.y, v.z, v.w};
      a_block(c, prime, kb, hi, lo);
      mma3_tiles(acc, 0, nj, hi, lo, B + (kb * NT + j0) * 32);
    }
  } else if (nj == 1) {
#pragma unroll
    for (int kb = 0; kb < kRegTiles; ++kb) {
      if (kb == kt) break;
      float c[4] = {rin[kb][0], rin[kb][1], rin[kb][2], rin[kb][3]};
      a_block(c, prime, kb, hi, lo);
      mma3_tiles(acc, kb, 1, hi, lo, B + (kb * NT + j0) * 32);
    }
#pragma unroll
    for (int kb = 1; kb < kRegTiles; ++kb) {
      if (kb == kt) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[0][q] = acc[0][q] + acc[kb][q];
    }
  } else {
#pragma unroll
    for (int kb = 0; kb < kRegTiles; ++kb) {
      if (kb == kt) break;
      float c[4] = {rin[kb][0], rin[kb][1], rin[kb][2], rin[kb][3]};
      a_block(c, prime, kb, hi, lo);
      mma3_tiles(acc, 0, nj, hi, lo, B + (kb * NT + j0) * 32);
    }
  }
}

// One layer over the warp's 16 rows, in fragment layout: out = f(in B + b)
// for in of kt 8-blocks and out of nt tiles, f = tanh or identity, b the
// staged bias (or none), in times tanh' of `prime` where given.  `act`
// holds the input (unless in_smem: the arena slots `ain`) and, where the
// output is at most kRegTiles tiles wide, receives it; a wider output goes
// to the arena slots `aout`, kRegTiles tiles at a time.  `stash`, where
// given, receives a copy of the output.
__device__ __forceinline__ void mma_layer(float (&act)[kRegTiles][4], bool in_smem,
                                          const float4* ain, float4* aout, const float4* B,
                                          int kt, int nt, const float* bias, bool tanh_out,
                                          const float4* prime, float4* stash) {
  const int t = threadIdx.x & 3;
  float acc[kRegTiles][4];
  for (int j0 = 0; j0 < nt; j0 += kRegTiles) {
    const int nj = nt - j0 < kRegTiles ? nt - j0 : kRegTiles;
    if (in_smem) {
      mma_tiles<true>(act, ain, prime, kt, B, nt, j0, nj, acc);
    } else {
      mma_tiles<false>(act, ain, prime, kt, B, nt, j0, nj, acc);
    }
#pragma unroll
    for (int j = 0; j < kRegTiles; ++j) {
      if (j == nj) break;
      if (bias) {
        const float2 b = *reinterpret_cast<const float2*>(bias + 8 * (j0 + j) + 2 * t);
        acc[j][0] = acc[j][0] + b.x;
        acc[j][1] = acc[j][1] + b.y;
        acc[j][2] = acc[j][2] + b.x;
        acc[j][3] = acc[j][3] + b.y;
      }
      if (tanh_out) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = tanhf(acc[j][q]);
      }
      const float4 v = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      if (stash) stash[(j0 + j) * 32] = v;
      if (nt > kRegTiles) aout[(j0 + j) * 32] = v;
    }
  }
  if (nt <= kRegTiles) {
#pragma unroll
    for (int j = 0; j < kRegTiles; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) act[j][q] = acc[j][q];
    }
  }
}

// This warp's region of shared memory.
__device__ __forceinline__ float* warp_region(float* sm, const MmaLayout& L) {
  return sm + L.net_floats + (threadIdx.x >> 5) * L.warp_floats;
}

// Write this lane's row of a [16, 8] lane tile (lane l < 16 columns 0-3,
// lane l+16 columns 4-7 of row l), then read the warp's first fragment of
// it: rows g and g+8, columns 2t and 2t+1.
__device__ __forceinline__ void tile_to_fragment(float* tile, const float (&row)[8],
                                                 float (&c)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, hi = lane >> 4;
  __syncwarp();
  *reinterpret_cast<float4*>(tile + (lane & 15) * 8 + 4 * hi) =
      hi ? make_float4(row[4], row[5], row[6], row[7])
         : make_float4(row[0], row[1], row[2], row[3]);
  __syncwarp();
  const float2 r0 = *reinterpret_cast<const float2*>(tile + g * 8 + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(tile + (g + 8) * 8 + 2 * t);
  c[0] = r0.x;
  c[1] = r0.y;
  c[2] = r1.x;
  c[3] = r1.y;
}

// The reverse: write the warp's first fragment c to the tile, read this
// lane's row (columns 0..n-1).
template <int N>
__device__ __forceinline__ void fragment_to_tile(float* tile, const float (&c)[4],
                                                 float (&row)[N]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
  *reinterpret_cast<float2*>(tile + g * 8 + 2 * t) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(tile + (g + 8) * 8 + 2 * t) = make_float2(c[2], c[3]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N; ++i) row[i] = tile[(lane & 15) * 8 + i];
}

// The layers of the MLP over the warp's rows from the input fragment in
// act[0]: all of them into act[0] (the output), or (kStash) all but the
// last, with each hidden layer's output stashed for mlp_mma_vjp.
template <bool kStash>
__device__ __forceinline__ void mlp_mma_layers(const float* sm, float* wsm, const NetArgs& a,
                                               const MmaLayout& L,
                                               float (&act)[kRegTiles][4]) {
  const int lane = threadIdx.x & 31, n = a.n_layers;
  float4* arena = reinterpret_cast<float4*>(wsm + L.arena) + lane;
  const int half = L.arena_tiles * 32;
  int cur = 0;
  bool in_smem = false;
  for (int l = 0; l < (kStash ? n - 1 : n); ++l) {
    const float4* B = reinterpret_cast<const float4*>(sm + L.fw[l]) + lane;
    float4* stash = kStash ? reinterpret_cast<float4*>(wsm + L.stash[l]) + lane : nullptr;
    mma_layer(act, in_smem, arena + cur * half, arena + (1 - cur) * half, B, L.kt[l], L.nt[l],
              sm + L.bias[l], l < n - 1, nullptr, stash);
    in_smem = L.nt[l] > kRegTiles;
    if (in_smem) cur = 1 - cur;
  }
}

// The net's input row [x, u] through norm_in, zero padded to 8.
template <int S, int U>
__device__ __forceinline__ void input_row(const float* sm, const MmaLayout& L,
                                          const float (&x)[S], const float (&u)[U],
                                          float (&row)[8]) {
#pragma unroll
  for (int i = 0; i < S; ++i) row[i] = x[i];
#pragma unroll
  for (int j = 0; j < U; ++j) row[S + j] = u[j];
#pragma unroll
  for (int i = S + U; i < 8; ++i) row[i] = 0.0f;
  if (L.norm[0] >= 0) {
#pragma unroll
    for (int i = 0; i < S + U; ++i) row[i] = (row[i] - sm[L.norm[0] + i]) / sm[L.norm[1] + i];
  }
}

// The MLP on this lane's rollout (pallas_neural.py:234-241 in JAX's
// order): out = norm_out(layers(norm_in([x, u]))), norms where present;
// the caller adds x (predict_delta) or the base step (K9).
template <int S, int U>
__device__ __forceinline__ void mlp_mma_step(float* sm, const NetArgs& a, const MmaLayout& L,
                                             const float (&x)[S], const float (&u)[U],
                                             float (&out)[S]) {
  float* wsm = warp_region(sm, L);
  float row[8], act[kRegTiles][4];
  input_row<S, U>(sm, L, x, u, row);
  tile_to_fragment(wsm + L.io, row, act[0]);
  mlp_mma_layers<false>(sm, wsm, a, L, act);
  fragment_to_tile<S>(wsm + L.io + kMmaRows * 8, act[0], out);
  if (L.norm[2] >= 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) out[i] = out[i] * sm[L.norm[3] + i] + sm[L.norm[2] + i];
  }
}

// lam^T d out / d(x, u) for mlp_mma_step at (x, u) (ops/adjoints.py
// mlp_step_vjp without the delta form's identity): the forward re-run for
// its hidden activations, then last to first norm_out (times std), each
// layer transposed (g @ W^T, after tanh' = 1 - a^2 on the hidden ones),
// norm_in (over std).
template <int S, int U>
__device__ __forceinline__ void mlp_mma_vjp(float* sm, const NetArgs& a, const MmaLayout& L,
                                            const float (&x)[S], const float (&u)[U],
                                            const float (&lam)[S], float (&gx)[S],
                                            float (&gu)[U]) {
  const int lane = threadIdx.x & 31, n = a.n_layers;
  float* wsm = warp_region(sm, L);
  float row[8], act[kRegTiles][4];
  input_row<S, U>(sm, L, x, u, row);
  tile_to_fragment(wsm + L.io, row, act[0]);
  mlp_mma_layers<true>(sm, wsm, a, L, act);
#pragma unroll
  for (int i = 0; i < S; ++i) row[i] = L.norm[2] >= 0 ? lam[i] * sm[L.norm[3] + i] : lam[i];
#pragma unroll
  for (int i = S; i < 8; ++i) row[i] = 0.0f;
  tile_to_fragment(wsm + L.io, row, act[0]);
  float4* arena = reinterpret_cast<float4*>(wsm + L.arena) + lane;
  const int half = L.arena_tiles * 32;
  int cur = 0;
  bool in_smem = false;
  for (int l = n - 1; l >= 0; --l) {
    const float4* B = reinterpret_cast<const float4*>(sm + L.tw[l]) + lane;
    const float4* prime = l < n - 1 ? reinterpret_cast<const float4*>(wsm + L.stash[l]) + lane
                                    : nullptr;
    mma_layer(act, in_smem, arena + cur * half, arena + (1 - cur) * half, B, L.nt[l], L.kt[l],
              nullptr, false, prime, nullptr);
    in_smem = L.kt[l] > kRegTiles;
    if (in_smem) cur = 1 - cur;
  }
  float g[S + U];
  fragment_to_tile<S + U>(wsm + L.io + kMmaRows * 8, act[0], g);
#pragma unroll
  for (int i = 0; i < S; ++i) gx[i] = L.norm[0] >= 0 ? g[i] / sm[L.norm[1] + i] : g[i];
#pragma unroll
  for (int j = 0; j < U; ++j) gu[j] = L.norm[0] >= 0 ? g[S + j] / sm[L.norm[1] + S + j] : g[S + j];
}

// The warp's rows: its first rollout, this lane's rollout k (lanes l and
// l+16 own row l), the rollout it reads (k, or K-1 past K) and whether it
// writes (lane < 16, k < K).  The member-block forms take the rows
// [begin, end) of the block's member, blockIdx.x counting blocks within it:
// the same, with K-1 read as end-1.
struct WarpRows {
  int first, k, kc;
  bool writes;
  __device__ __forceinline__ explicit WarpRows(int K) {
    const int lane = threadIdx.x & 31;
    first = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kMmaRows;
    k = first + (lane & 15);
    kc = k < K ? k : K - 1;
    writes = lane < 16 && k < K;
  }
  __device__ __forceinline__ WarpRows(int begin, int end) {
    const int lane = threadIdx.x & 31;
    first = begin + (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kMmaRows;
    k = first + (lane & 15);
    kc = k < end ? k : end - 1;
    writes = lane < 16 && k < end;
  }
};

// ---- the value_spec forms (value_mlp.cuh) -----------------------------------

// plan_mma with the value net of v staged after the warps' regions, and
// its activations' kValueCols columns; -1 where either net is refused.
inline long plan_mma_value(const NetArgs& a, const ValueArgs& v, int S, int U, MmaLayout& L) {
  if (!value_net_ok(v, S)) return -1;
  return plan_mma(a, S, U, L, static_cast<long>(value_smem_bytes(v, kValueCols)));
}

// The value net's region of shared memory (plan_mma_value).
__device__ __forceinline__ float* value_region(float* sm, const MmaLayout& L) {
  return sm + L.net_floats + L.warps * L.warp_floats;
}

// V(x_H) and ct * dV/dx_H of the staged value net for this lane's rollout:
// lane l < 16 evaluates them in its rollout's column and lane l+16 takes
// its bits by a shuffle.  Every lane of the warp calls it.
template <int S>
__device__ __forceinline__ float value_mma_tail(float* sm, const MmaLayout& L,
                                                const ValueArgs& v, const float (&x)[S],
                                                float ct, float (&gx)[S]) {
  const int row = threadIdx.x & 15;
  return value_from_lane<S, kValueCols>(x, value_region(sm, L), v, row,
                                        (threadIdx.x >> 5) * kMmaRows + row, ct, gx);
}

// Plan the net's layout, allow the shared memory and launch `kernel` over
// `members` blocks of `rows` rollouts (blockIdx.y the block's member; one
// member of K rollouts for the single-net kernels), kMmaRows a warp and
// L.warps warps a block.
template <class Kernel, class... Args>
int launch_mma_members(Kernel kernel, long& allowed, const NetArgs& net, int S, int U, int rows,
                       int members, void* stream, Args... args) {
  MmaLayout L;
  const long bytes = plan_mma(net, S, U, L);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = L.warps * kMmaRows;
  const dim3 grid((rows + per_block - 1) / per_block, members);
  kernel<<<grid, 32 * L.warps, bytes, static_cast<cudaStream_t>(stream)>>>(args..., net, L);
  return static_cast<int>(cudaGetLastError());
}

// launch_mma_members over one member of K rollouts.
template <class Kernel, class... Args>
int launch_mma(Kernel kernel, long& allowed, const NetArgs& net, int S, int U, int K,
               void* stream, Args... args) {
  return launch_mma_members(kernel, allowed, net, S, U, K, 1, stream, args...);
}

// launch_mma_members for a value_spec form: the layout of plan_mma_value,
// the value net's ValueArgs after the layout.
template <class Kernel, class... Args>
int launch_mma_value(Kernel kernel, long& allowed, const NetArgs& net, const ValueArgs& v, int S,
                     int U, int rows, int members, void* stream, Args... args) {
  MmaLayout L;
  const long bytes = plan_mma_value(net, v, S, U, L);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = L.warps * kMmaRows;
  const dim3 grid((rows + per_block - 1) / per_block, members);
  kernel<<<grid, 32 * L.warps, bytes, static_cast<cudaStream_t>(stream)>>>(args..., net, L, v);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a value_spec form's `kernel` an SM holds (0 where refused).
template <class Kernel>
int mma_value_blocks_per_sm(Kernel kernel, long& allowed, const NetArgs& net, const ValueArgs& v,
                            int S, int U) {
  MmaLayout L;
  const long bytes = plan_mma_value(net, v, S, U, L);
  int blocks = 0;
  if (bytes < 0 || allow_smem(kernel, bytes, allowed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * L.warps, bytes) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}

// Blocks of `kernel` an SM holds for `net` (0 where the net is refused).
template <class Kernel>
int mma_blocks_per_sm(Kernel kernel, long& allowed, const NetArgs& net, int S, int U) {
  MmaLayout L;
  const long bytes = plan_mma(net, S, U, L);
  int blocks = 0;
  if (bytes < 0 || allow_smem(kernel, bytes, allowed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * L.warps, bytes) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}

}  // namespace ctt
