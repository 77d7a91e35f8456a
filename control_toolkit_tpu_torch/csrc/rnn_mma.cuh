// The tensor-core recurrent step of K13 (stacked GRU/LSTM rollout + cost,
// neural_rollout.cu).  It replaces the Pallas kernel's cells
// (control_toolkit_tpu/ops/pallas_neural.py:526-586), which ran each gate
// product as one MXU matmul over a [features, tile] slab in VMEM.
//
// Design, for Hopper's mma.sync (mlp_mma.cuh's machinery: 3xTF32 m16n8k8
// products, weights split hi/lo once at staging in B-fragment order, the
// k index permuted inside each 8-block so that a C fragment is the next
// product's A fragment):
// - A group of W warps (up to kRnnGroupWarps) owns 16 rollouts, one m16
//   tile, and splits each layer by hidden unit: warp w computes the unit
//   tiles j = w, w + W, .. (8 units each) of every gate (r, z, n for the
//   GRU; i, f, g, o for the LSTM), so the gate nonlinearities and h' of a
//   unit stay in the warp that computed them.  A warp with no tile of a
//   narrow layer only waits at its barrier.
// - Each gate keeps the input product x @ wi and the recurrent product
//   h @ wh apart (the GRU's n gate needs them apart, r * (gh_n + bh_n));
//   each k-block's three split products go to a partial sum of their own
//   (the first from a zero accumulator), added to the gate's sum in k
//   order: short mma chains, two k-blocks' at a time interleaved, and FP32
//   adds outside the tensor core's accumulator.  The biases are added in the
//   plain cells' order.
// - Sharing h: a layer's new h [16, Hd] goes through a per-group slab of
//   shared memory as A fragments already split (tile j's hi and lo at
//   [(2j) * 32 + lane] and [(2j + 1) * 32 + lane], a float4 each a lane),
//   so the warp that computed a tile splits it once and every reader only
//   loads it; the slab is double-buffered by step, so a warp writes the new
//   h while the others still read the old one; one named barrier (bar.sync
//   1 + group, 32 W threads) a layer syncs only the group's warps, and
//   nothing block-wide runs inside the horizon loop.  Each tile's own
//   state, the GRU's h unsplit and the LSTM's c, stays in its warp's lanes
//   (a lane-private float4 of shared memory), read and written by no
//   other warp.
// - The head (S outputs, one tile): the warp that computes tile j of the
//   last layer also takes its k-block j of the head's product (a partial
//   sum from zero) into a per-group slot before the layer's barrier; after
//   it every warp adds the slots in k order.  That and the scalar work (the
//   stage cost, the delta add) run on every warp of the group, lanes l and
//   l+16 owning rollout l as in mlp_mma.cuh, so no barrier follows them;
//   warp 0 writes the cost.
// - Widths need not be multiples of 8: weights, biases and the start
//   hidden are padded with zeros, and a padded unit stays 0.
// Rows past K (ragged K, or K < 16) repeat rollout K-1 and write nothing;
// a group with no row below K returns after the block's staging.  The
// host side (plan_rnn) lays out the staged net and the groups' regions and
// refuses a net that is not a GRU/LSTM of 1..kMaxLayers cells on an input
// of at most 8, or a block beyond sm_90's shared memory (the entry point
// then returns cudaErrorInvalidValue).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_mma.cuh"

namespace ctt {

constexpr int kRnnGroupWarps = 4;  // warps per 16-rollout group, at most
constexpr int kRnnThreads = 512;   // threads per block, at most

// Offsets (floats) of the staged net and of each group's region.
struct RnnLayout {
  int nt[kMaxLayers], kti[kMaxLayers];  // layer l: unit tiles, k-blocks of its input
  int wi[kMaxLayers], wh[kMaxLayers];   // B fragments, hi/lo split
  int bi[kMaxLayers], bh[kMaxLayers];   // G blocks of 8 nt, padded with zeros
  int wo, bo, kto;                      // head: fragments, bias (8), k-blocks
  int net_floats;
  // In a group's region: layer l's split h slabs (two of nt tiles, hi and
  // lo) and its lane-private state (nt tiles: the GRU's h, the LSTM's c),
  // the head's partial sums (two of kto tiles), then one [16, 8] lane tile
  // a warp.
  int h[kMaxLayers], own[kMaxLayers], head, io;
  int group_floats;
  int warps;   // W, per group
  int groups;  // per block
};

// Lay out `a` for a plant of S states and U controls; returns the block's
// dynamic shared memory in bytes, or -1 for a net the kernel refuses.  A
// group takes one warp per unit tile of the widest layer, up to
// kRnnGroupWarps; a block the most groups (kRnnThreads at most) that fit.
inline long plan_rnn(const NetArgs& a, int S, int U, RnnLayout& L) {
  int off = 0, grp = 0, widest = 0;
  auto take = [&off](int n) { const int o = off; off += pad_to(n, 4); return o; };
  const int n = a.n_layers;
  if ((a.kind != kNetGRU && a.kind != kNetLSTM) || n < 1 || n > kMaxLayers || S + U > 8 ||
      a.dims[0] != S + U) {
    return -1;
  }
  const int G = gates_of(a.kind);
  for (int l = 0; l < n; ++l) {
    if (a.dims[l + 1] < 1) return -1;
    const int nt = pad_to(a.dims[l + 1], 8) / 8;
    L.nt[l] = nt;
    L.kti[l] = pad_to(a.dims[l], 8) / 8;
    L.wi[l] = take(nt * L.kti[l] * G * kTileFloats);
    L.wh[l] = take(nt * nt * G * kTileFloats);
    L.bi[l] = take(G * 8 * nt);
    L.bh[l] = take(G * 8 * nt);
    L.h[l] = grp;
    grp += 2 * 2 * nt * kTileFloats;
    L.own[l] = grp;
    grp += nt * kTileFloats;
    widest = nt > widest ? nt : widest;
  }
  L.kto = L.nt[n - 1];
  L.wo = take(L.kto * kTileFloats);
  L.bo = take(8);
  L.net_floats = off;
  L.warps = widest < kRnnGroupWarps ? widest : kRnnGroupWarps;
  L.head = grp;
  grp += 2 * L.kto * kTileFloats;
  L.io = grp;
  grp += L.warps * kMmaRows * 8;
  L.group_floats = grp;
  for (L.groups = kRnnThreads / (32 * L.warps); L.groups >= 1; --L.groups) {
    const long bytes = 4L * (off + static_cast<long>(L.groups) * grp);
    if (bytes <= kMaxSmem) return bytes;
  }
  return -1;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---- staging ---------------------------------------------------------------

// The split B fragments of M [rows, G*n], gate g's n columns at g*n, for
// KT k-blocks and NT unit tiles: fragment ((j * KT + kb) * G + g) at
// [.. * 32 + lane] (float4s), lane (q, t) holding rows 8kb + 2t and
// 8kb + 2t + 1 (the permuted k order) of column g*n + 8j + q.
__device__ __forceinline__ void stage_gate_fragments(float* dst, const float* __restrict__ M,
                                                     int rows, int n, int G, int KT, int NT) {
  float4* out = reinterpret_cast<float4*>(dst);
  const int len = NT * KT * G * 32;
  for (int idx = threadIdx.x; idx < len; idx += blockDim.x) {
    const int lane = idx & 31, f = idx >> 5, q = lane >> 2, t = lane & 3;
    const int g = f % G, kb = f / G % KT, j = f / G / KT;
    const int k = 8 * kb + 2 * t, col = 8 * j + q;
    const float* m = M + g * n + col;
    const size_t ld = static_cast<size_t>(G) * n;
    out[idx] = split_pair(k < rows && col < n ? __ldg(m + k * ld) : 0.0f,
                          k + 1 < rows && col < n ? __ldg(m + (k + 1) * ld) : 0.0f);
  }
}

// Stage the whole net; the caller then synchronises the block.
template <int G>
__device__ __forceinline__ void stage_rnn_net(float* sm, const NetArgs& a, const RnnLayout& L,
                                              int S) {
  const int n = a.n_layers;
  for (int l = 0; l < n; ++l) {
    const int din = a.dims[l], hd = a.dims[l + 1], nt = L.nt[l];
    stage_gate_fragments(sm + L.wi[l], a.w[l], din, hd, G, L.kti[l], nt);
    stage_gate_fragments(sm + L.wh[l], a.wh[l], hd, hd, G, nt, nt);
    stage_rows(sm + L.bi[l], a.b[l], 1, G, hd, 8 * nt);
    stage_rows(sm + L.bh[l], a.bh[l], 1, G, hd, 8 * nt);
  }
  stage_gate_fragments(sm + L.wo, a.wo, a.dims[n], S, 1, L.kto, 1);
  stage_rows(sm + L.bo, a.bo, 1, 1, S, 8);
}

// ---- the step --------------------------------------------------------------

// Sync the group's W warps (named barrier 1 + group; a warp alone syncs
// itself).
__device__ __forceinline__ void group_sync(int group, int warps) {
  if (warps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * warps) : "memory");
  }
}

// d = a b over one m16n8k8 tile from a zero accumulator, FP32.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// acc[g] += sum over p < P of A(p) B(p, g) for the G gates of P
// consecutive k-blocks in 3xTF32, B(p, g) = {b0_hi, b1_hi, b0_lo, b1_lo}
// at b[p * kb_stride + g * 32] (K13: G gates of a unit tile, kb_stride =
// G * 32; K11, mlp_units.cuh: G consecutive unit tiles of a layer of NT,
// kb_stride = NT * 32): a_lo b_hi, then a_hi b_lo, then a_hi b_hi into a
// partial sum a k-block from zero, each product over all P * G
// tiles before the next (P * G independent chains of three mma); the
// partial sums are then added to acc in k order.
template <int G, int P>
__device__ __forceinline__ void mma3_blocks(float (&acc)[G][4], const uint32_t (&hi)[P][4],
                                            const uint32_t (&lo)[P][4], const float4* b,
                                            int kb_stride) {
  float4 f[P][G];
  float part[P][G][4];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int g = 0; g < G; ++g) f[p][g] = b[p * kb_stride + g * 32];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mma_tf32_zero(part[p][g], lo[p], __float_as_uint(f[p][g].x), __float_as_uint(f[p][g].y));
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mma_tf32(part[p][g], hi[p], __float_as_uint(f[p][g].z), __float_as_uint(f[p][g].w));
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mma_tf32(part[p][g], hi[p], __float_as_uint(f[p][g].x), __float_as_uint(f[p][g].y));
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = acc[g][q] + part[p][g][q];
    }
  }
}

// This lane's split A fragments of k-blocks kb0 .. kb0 + P - 1 of a split
// slab.
template <int P>
__device__ __forceinline__ void load_split(const float4* slab, int kb0, uint32_t (&hi)[P][4],
                                           uint32_t (&lo)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float4 h = slab[2 * (kb0 + p) * 32], l = slab[(2 * (kb0 + p) + 1) * 32];
    hi[p][0] = __float_as_uint(h.x);
    hi[p][1] = __float_as_uint(h.y);
    hi[p][2] = __float_as_uint(h.z);
    hi[p][3] = __float_as_uint(h.w);
    lo[p][0] = __float_as_uint(l.x);
    lo[p][1] = __float_as_uint(l.y);
    lo[p][2] = __float_as_uint(l.z);
    lo[p][3] = __float_as_uint(l.w);
  }
}

// acc[g] = sum over kb < kt of A(kb) B(kb, g): A(kb) the split slab's
// tile kb (all kt of them), B the layer's fragments of unit tile j plus
// the lane, k-block kb's at B + kb * kb_stride; two k-blocks at a time, so
// that their mma chains overlap.
template <int G>
__device__ __forceinline__ void gate_products(const float4* slab, int kt, const float4* B,
                                              int kb_stride, float (&acc)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[g][q] = 0.0f;
  }
  int kb = 0;
  for (; kb + 2 <= kt; kb += 2) {
    uint32_t hi[2][4], lo[2][4];
    load_split<2>(slab, kb, hi, lo);
    mma3_blocks<G, 2>(acc, hi, lo, B + kb * kb_stride, kb_stride);
  }
  if (kb < kt) {
    uint32_t hi[1][4], lo[1][4];
    load_split<1>(slab, kb, hi, lo);
    mma3_blocks<G, 1>(acc, hi, lo, B + kb * kb_stride, kb_stride);
  }
}

// Store the split A fragment (hi, lo) of k-block j (a_fragment of tile j's
// C fragment) into a split slab (plus the lane).
__device__ __forceinline__ void put_split(float4* slab, int j, const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4]) {
  slab[2 * j * 32] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                                 __uint_as_float(hi[2]), __uint_as_float(hi[3]));
  slab[(2 * j + 1) * 32] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                       __uint_as_float(lo[2]), __uint_as_float(lo[3]));
}

// Fill this warp's tiles (j = w, w + W, ..) of each layer's first split h
// slab and of its own state (the GRU's h, the LSTM's c) from the hidden,
// [h] (GRU) or [h, c] (LSTM) a row: fragment row r (rollout first + r, or
// K-1 past K) takes row (first + r) / ks, its session's, so that a group
// straddling two sessions starts each rollout from its own; units past the
// width 0.
template <int G>
__device__ __forceinline__ void rnn_mma_start(float* gsm, const NetArgs& a, const RnnLayout& L,
                                              int w, int first, int K, int ks) {
  const int lane = threadIdx.x & 31, t = lane & 3, q = lane >> 2;
  const int b0 = min(first + q, K - 1) / ks, b1 = min(first + q + 8, K - 1) / ks;
  for (int l = 0; l < a.n_layers; ++l) {
    const int hd = a.dims[l + 1], width = G == 4 ? 2 * hd : hd;
    const float* hid0 = a.hidden[l] + static_cast<size_t>(b0) * width;
    const float* hid1 = a.hidden[l] + static_cast<size_t>(b1) * width;
    for (int j = w; j < L.nt[l]; j += L.warps) {
      const int u0 = 8 * j + 2 * t;
      // Values 0, 1: row q's units u0, u0 + 1; values 2, 3: row q + 8's:
      // h, then (the LSTM) c in the same registers.
      auto load = [&](const float* h, int u) { return u < hd ? __ldg(h + u) : 0.0f; };
      float v[4] = {load(hid0, u0), load(hid0, u0 + 1), load(hid1, u0), load(hid1, u0 + 1)};
      uint32_t hi[4], lo[4];
      a_fragment(v, hi, lo);
      put_split(reinterpret_cast<float4*>(gsm + L.h[l]) + lane, j, hi, lo);
      if constexpr (G == 4) {
        v[0] = load(hid0 + hd, u0);
        v[1] = load(hid0 + hd, u0 + 1);
        v[2] = load(hid1 + hd, u0);
        v[3] = load(hid1 + hd, u0 + 1);
      }
      reinterpret_cast<float4*>(gsm + L.own[l])[j * 32 + lane] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One step of the stacked cells and the head (pallas_neural.py:526-586,
// models/networks.py) over the group's 16 rows, this warp's share of each
// layer: G = 3 the GRU (r = s(gi_r + gh_r), z = s(gi_z + gh_z),
// n = tanh(gi_n + r * gh_n), h' = (1 - z) * n + z * h, gi = x @ wi + bi,
// gh = h @ wh + bh), G = 4 the LSTM (gates i, f, g, o of
// ((x @ wi + bi) + h @ wh) + bh; c' = f * c + i * tanh(g), h' = o * tanh(c')).
// Split h slab `cur` holds each layer's h, slab 1 - cur receives h'.
template <int G, int S, int U>
__device__ __forceinline__ void rnn_mma_step(const float* sm, float* gsm, float* io,
                                             const NetArgs& a, const RnnLayout& L, int group,
                                             int w, int cur, float (&x)[S],
                                             const float (&u)[U]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  float row[8], in[4];
#pragma unroll
  for (int i = 0; i < S; ++i) row[i] = x[i];
#pragma unroll
  for (int j = 0; j < U; ++j) row[S + j] = u[j];
#pragma unroll
  for (int i = S + U; i < 8; ++i) row[i] = 0.0f;
  tile_to_fragment(io, row, in);
  uint32_t in_hi[1][4], in_lo[1][4];
  a_fragment(in, in_hi[0], in_lo[0]);
  // The head's partial sums, by step parity (a fast warp's next step
  // writes the other buffer while a slow one still reads this one).
  float4* head = reinterpret_cast<float4*>(gsm + L.head) + cur * L.kto * 32 + lane;
  const float4* inp = nullptr;  // the layer's input slab; layer 0: `in`
  for (int l = 0; l < a.n_layers; ++l) {
    const int nt = L.nt[l], hdp = 8 * nt;
    const float4* hs = reinterpret_cast<const float4*>(gsm + L.h[l]) + cur * 2 * nt * 32 + lane;
    float4* hn = reinterpret_cast<float4*>(gsm + L.h[l]) + (1 - cur) * 2 * nt * 32 + lane;
    float4* own = reinterpret_cast<float4*>(gsm + L.own[l]) + lane;
    for (int j = w; j < nt; j += L.warps) {
      float ai[G][4], ah[G][4];
      const float4* Bi =
          reinterpret_cast<const float4*>(sm + L.wi[l]) + j * L.kti[l] * G * 32 + lane;
      const float4* Bh = reinterpret_cast<const float4*>(sm + L.wh[l]) + j * nt * G * 32 + lane;
      if (l == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int q = 0; q < 4; ++q) ai[g][q] = 0.0f;
        }
        mma3_blocks<G, 1>(ai, in_hi, in_lo, Bi, G * 32);
      } else {
        gate_products<G>(inp, L.kti[l], Bi, G * 32, ai);
      }
      gate_products<G>(hs, nt, Bh, G * 32, ah);
      // Lane (q, t) holds rows q and q+8 of units 8j + 2t (values 0, 2)
      // and 8j + 2t + 1 (values 1, 3).
      float2 bi[G], bh[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        bi[g] = *reinterpret_cast<const float2*>(sm + L.bi[l] + g * hdp + 8 * j + 2 * t);
        bh[g] = *reinterpret_cast<const float2*>(sm + L.bh[l] + g * hdp + 8 * j + 2 * t);
      }
      const float4 sv = own[j * 32];
      float st[4] = {sv.x, sv.y, sv.z, sv.w}, out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool odd = q & 1;
        if constexpr (G == 3) {
          const float r = sigmoid((ai[0][q] + (odd ? bi[0].y : bi[0].x)) +
                                  (ah[0][q] + (odd ? bh[0].y : bh[0].x)));
          const float z = sigmoid((ai[1][q] + (odd ? bi[1].y : bi[1].x)) +
                                  (ah[1][q] + (odd ? bh[1].y : bh[1].x)));
          const float nn = tanhf((ai[2][q] + (odd ? bi[2].y : bi[2].x)) +
                                 r * (ah[2][q] + (odd ? bh[2].y : bh[2].x)));
          st[q] = out[q] = (1.0f - z) * nn + z * st[q];
        } else {
          float gate[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            gate[g] = ((ai[g][q] + (odd ? bi[g].y : bi[g].x)) + ah[g][q]) +
                      (odd ? bh[g].y : bh[g].x);
          }
          st[q] = sigmoid(gate[1]) * st[q] + sigmoid(gate[0]) * tanhf(gate[2]);
          out[q] = sigmoid(gate[3]) * tanhf(st[q]);
        }
      }
      own[j * 32] = make_float4(st[0], st[1], st[2], st[3]);
      uint32_t hi[1][4], lo[1][4];
      a_fragment(out, hi[0], lo[0]);
      put_split(hn, j, hi[0], lo[0]);
      if (l == a.n_layers - 1) {  // k-block j of the head's product
        float part[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
        const float4* Bo = reinterpret_cast<const float4*>(sm + L.wo) + j * 32 + lane;
        mma3_blocks<1, 1>(part, hi, lo, Bo, 32);
        head[j * 32] = make_float4(part[0][0], part[0][1], part[0][2], part[0][3]);
      }
    }
    group_sync(group, L.warps);
    inp = hn;
  }
  // out = h' @ wo + bo on every warp: the head's partial sums in k order.
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kb = 0; kb < L.kto; ++kb) {
    const float4 v = head[kb * 32];
    o[0] = o[0] + v.x;
    o[1] = o[1] + v.y;
    o[2] = o[2] + v.z;
    o[3] = o[3] + v.w;
  }
  const float2 bo = *reinterpret_cast<const float2*>(sm + L.bo + 2 * t);
  const float out[4] = {o[0] + bo.x, o[1] + bo.y, o[2] + bo.x, o[3] + bo.y};
  float y[S];
  fragment_to_tile<S>(io, out, y);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = a.predict_delta ? x[i] + y[i] : y[i];
}

}  // namespace ctt
