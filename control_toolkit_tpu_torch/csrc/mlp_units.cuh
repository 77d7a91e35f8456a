// The unit-split tensor-core MLP step of K11 (MLP rollout + cost,
// neural_rollout.cu) and K12 (the residual rollout + cost, one warp a
// group, residual_rollout.cu).  It replaces the Pallas kernels' row-MLP
// (control_toolkit_tpu/ops/pallas_neural.py:mlp_rows, the step at
// :234-241), which ran each layer as one MXU matmul over a [features, tile]
// slab in VMEM.
//
// Design: K13's (rnn_mma.cuh) with one gate and no recurrence, over K8's
// staged net (mlp_mma.cuh: 3xTF32 m16n8k8 mma.sync, the weights split
// hi/lo once at staging in B-fragment order with the k index permuted in
// each 8-block, so that a C fragment is the next product's A fragment;
// forward fragments only):
// - A group of W warps owns 16 rollouts, one m16 tile; W is one a four
//   unit tiles of the widest hidden layer, up to kRnnGroupWarps (the caller
//   may ask for 1, 2 or 4).  For mlp-64-64 that is W = 2, the fastest on
//   an H100 80GB HBM3 at 700 W (PERF.md: about 0.50 ms at W = 1, 0.35 at
//   2, 0.45 at 4): more warps add barrier members and copies of the
//   scalar work, fewer lengthen each warp's chain.  Warp w computes a
//   contiguous run of ceil(nt / W) output tiles of every hidden layer, two
//   at a time: each k-block's three split products into a partial sum of
//   its own, the two tiles' chains side by side, added in k order
//   (gate_products), then bias and tanh on the fragment.
// - Hidden layer l's output goes, already split hi/lo, to the group's slab
//   l (put_split), read back split by every warp of the group (load_split),
//   with one named barrier a layer (group_sync) and nothing block-wide
//   inside the horizon loop.  One slab a layer is enough: a warp writes
//   slab l at step h+1 only after the barrier of layer l+1 at step h,
//   which every warp reaches after its last read of slab l.
// - The last layer (S outputs, one tile): the warp that computes tile j of
//   the last hidden layer takes k-block j of the output product (a partial
//   sum from zero) into a per-group slot before the layer's barrier; after
//   it every warp adds the slots in k order.  The slots are double-buffered
//   by step parity: over one hidden layer, a fast warp writes step h+1's
//   slots while a slow one may still read step h's.
// - The scalar work (norm_in, the stage cost, norm_out, the delta add) runs
//   on every warp of the group, lanes l and l+16 owning rollout l as in
//   mlp_mma.cuh, so no barrier follows it; warp 0 writes the cost.  A net
//   of one layer (no hidden layer) takes W = 1: each warp computes the
//   output tile itself.
// - Widths need not be multiples of 8: weights and biases are padded with
//   zeros, and a padded unit is tanh(0) = 0.
// Rows past K (ragged K, or K < 16) repeat rollout K-1 and write nothing; a
// group with no row below K returns after the block's staging.  The host
// side (plan_mlp_units) refuses what the network kernels refuse (not an MLP,
// more than kMaxLayers layers, widths that do not chain, a block beyond
// sm_90's shared memory); the entry point then returns
// cudaErrorInvalidValue.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "rnn_mma.cuh"

namespace ctt {

// Offsets (floats) of the staged net and of each group's region.
struct MlpUnitsLayout {
  MmaLayout net;  // the staged net: forward fragments, biases, norms
  // In a group's region: hidden layer l's split output slab (2 nt tiles,
  // for l < n - 2), the output product's partial sums (two of kto tiles,
  // kto the last layer's k-blocks), then one [16, 8] lane tile a warp.
  int slab[kMaxLayers], head, kto, io;
  int group_floats;
  int warps;   // W, per group
  int groups;  // per block
};

// Lay out `a` for a plant of S states and U controls with `warps` warps a
// group (0: the plan's own); returns the block's dynamic shared memory in
// bytes, or -1 for a net the kernel refuses.  A block takes the most groups
// (kRnnThreads threads at most) that fit.
inline long plan_mlp_units(const NetArgs& a, int S, int U, int warps, MlpUnitsLayout& L) {
  if (plan_mma_net(a, S, U, false, L.net) < 0) return -1;
  const int n = a.n_layers;
  int grp = 0, widest = 1;
  for (int l = 0; l < n - 1; ++l) {
    const int nt = L.net.nt[l];
    widest = nt > widest ? nt : widest;
    if (l < n - 2) {
      L.slab[l] = grp;
      grp += 2 * nt * kTileFloats;
    }
  }
  L.kto = n > 1 ? L.net.kt[n - 1] : 0;
  L.head = grp;
  grp += 2 * L.kto * kTileFloats;
  const int quads = (widest + 3) / 4;  // the plan's W: a warp per four unit tiles
  L.warps = warps > 0 ? warps : (quads < kRnnGroupWarps ? quads : kRnnGroupWarps);
  L.io = grp;
  grp += L.warps * kMmaRows * 8;
  L.group_floats = grp;
  for (L.groups = kRnnThreads / (32 * L.warps); L.groups >= 1; --L.groups) {
    const long bytes = 4L * (L.net.net_floats + static_cast<long>(L.groups) * grp);
    if (bytes <= kMaxSmem) return bytes;
  }
  return -1;
}

// Unit tiles j .. j+G-1 of hidden layer l over the group's 16 rows: each
// k-block's split products into a partial sum of its own (G tiles' chains
// side by side), added in k order, then bias and tanh; each tile's output,
// split, goes to the slab `out` or, for the last hidden layer (`out`
// null), takes k-block j + g of the output product into its slot of
// `head`.
template <int G>
__device__ __forceinline__ void unit_tiles(const float* sm, const MmaLayout& N, int l, int j,
                                           const uint32_t (&in_hi)[1][4],
                                           const uint32_t (&in_lo)[1][4], const float4* inp,
                                           float4* out, float4* head, const float4* Bo) {
  const int lane = threadIdx.x & 31, t = lane & 3, nt = N.nt[l];
  const float4* B = reinterpret_cast<const float4*>(sm + N.fw[l]) + lane + j * 32;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[g][q] = 0.0f;
  }
  if (l == 0) {
    mma3_blocks<G, 1>(acc, in_hi, in_lo, B, nt * 32);
  } else {
    gate_products<G>(inp, N.kt[l], B, nt * 32, acc);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // Lane (q, t) holds rows q and q+8 of units 8(j+g) + 2t (values 0, 2)
    // and 8(j+g) + 2t + 1 (values 1, 3).
    const float2 b = *reinterpret_cast<const float2*>(sm + N.bias[l] + 8 * (j + g) + 2 * t);
    const float v[4] = {tanhf(acc[g][0] + b.x), tanhf(acc[g][1] + b.y),
                        tanhf(acc[g][2] + b.x), tanhf(acc[g][3] + b.y)};
    uint32_t hi[1][4], lo[1][4];
    a_fragment(v, hi[0], lo[0]);
    if (out) {
      put_split(out, j + g, hi[0], lo[0]);
    } else {  // k-block j + g of the output product
      float part[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
      mma3_blocks<1, 1>(part, hi, lo, Bo + (j + g) * 32, 32);
      head[(j + g) * 32] = make_float4(part[0][0], part[0][1], part[0][2], part[0][3]);
    }
  }
}

// One MLP transition (pallas_neural.py:234-241, NeuralPredictor.single_step
// in JAX's order) over the group's 16 rows, this warp's share of each
// layer (its unit tiles, kG at a time, then two, then one): [x, u] through
// norm_in, each layer a @ W + b with tanh on all but the last, norm_out,
// then x + a (predict_delta) or a.  Partial-sum slots `cur` (the step's
// parity) receive the output product's k-blocks.
template <int S, int U, int kG = 2>
__device__ __forceinline__ void mlp_units_step(const float* sm, float* gsm, float* io,
                                               const NetArgs& a, const MlpUnitsLayout& L,
                                               int group, int w, int cur, float (&x)[S],
                                               const float (&u)[U]) {
  const int lane = threadIdx.x & 31, t = lane & 3, n = a.n_layers;
  const MmaLayout& N = L.net;
  float row[8], in[4];
  input_row<S, U>(sm, N, x, u, row);
  tile_to_fragment(io, row, in);
  uint32_t in_hi[1][4], in_lo[1][4];
  a_fragment(in, in_hi[0], in_lo[0]);
  const float4* Bo = reinterpret_cast<const float4*>(sm + N.fw[n - 1]) + lane;
  float o[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
  if (n == 1) {
    mma3_blocks<1, 1>(o, in_hi, in_lo, Bo, 32);
  } else {
    float4* head = reinterpret_cast<float4*>(gsm + L.head) + cur * L.kto * 32 + lane;
    const float4* inp = nullptr;  // the layer's input slab; layer 0: `in`
    for (int l = 0; l < n - 1; ++l) {
      float4* out = l < n - 2 ? reinterpret_cast<float4*>(gsm + L.slab[l]) + lane : nullptr;
      const int per = (N.nt[l] + L.warps - 1) / L.warps;
      const int first = w * per, last = first + per < N.nt[l] ? first + per : N.nt[l];
      int j = first;
      for (; j + kG <= last; j += kG) unit_tiles<kG>(sm, N, l, j, in_hi, in_lo, inp, out, head, Bo);
      if constexpr (kG > 2) {
        for (; j + 2 <= last; j += 2) unit_tiles<2>(sm, N, l, j, in_hi, in_lo, inp, out, head, Bo);
      }
      if (j < last) unit_tiles<1>(sm, N, l, j, in_hi, in_lo, inp, out, head, Bo);
      group_sync(group, L.warps);
      inp = out;
    }
    for (int kb = 0; kb < L.kto; ++kb) {
      const float4 v = head[kb * 32];
      o[0][0] = o[0][0] + v.x;
      o[0][1] = o[0][1] + v.y;
      o[0][2] = o[0][2] + v.z;
      o[0][3] = o[0][3] + v.w;
    }
  }
  const float2 bo = *reinterpret_cast<const float2*>(sm + N.bias[n - 1] + 2 * t);
  const float out[4] = {o[0][0] + bo.x, o[0][1] + bo.y, o[0][2] + bo.x, o[0][3] + bo.y};
  float y[S];
  fragment_to_tile<S>(io, out, y);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (N.norm[2] >= 0) y[i] = y[i] * sm[N.norm[3] + i] + sm[N.norm[2] + i];
    x[i] = a.predict_delta ? x[i] + y[i] : y[i];
  }
}

}  // namespace ctt
