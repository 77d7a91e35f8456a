// The network core of the network-rollout kernel K12 (residual rollout +
// cost, residual_rollout.cu), and the net's description that every network
// kernel takes.  It replaces the Pallas kernels' row-MLP
// (control_toolkit_tpu/ops/pallas_neural.py:mlp_rows), which ran each layer
// as one MXU matmul over a [features, tile] slab in VMEM.  The other
// network kernels run their products on tensor cores instead: K8 and K9
// (mlp_mma.cuh), K11 (mlp_units.cuh) and K13 (rnn_mma.cuh).
//
// Design (one thread owns one rollout, as in rollout_core.cuh):
// - A block first stages the net into dynamic shared memory: each weight
//   matrix row-major with its row padded with zeros to a multiple of the
//   output chunk, so that every thread reads a float4 of weights per input
//   as a broadcast.  The `transposed` layout adds a transposed copy of
//   each MLP matrix and two gradient columns, for a backward's `g @ W^T` in
//   the same loop (the one-thread-per-rollout K8 and K9 took it; no kernel
//   does now).  The net's tensors
//   arrive as they are stored (w [in, out]): no copy or transpose is
//   dispatched per call, and a new weight tensor is a new pointer, never a
//   rebuild.
// - Each thread's activations and gradients live in its own
//   columns of shared memory after the weights (element i of a column
//   array at i * kThreads + threadIdx.x: consecutive threads, consecutive
//   banks), so layers of any width up to what fits are runtime loops, and
//   no thread reads another's column: the only barrier is after staging.
// - A layer is computed kChunk outputs at a time, their sums in registers:
//   per input, one column load and kChunk/4 float4 weight loads feed kChunk
//   FMAs.
// The host side (plan_layout) lays the staged net and the columns out and
// refuses a net of more than kMaxLayers layers, of widths that do not chain,
// or whose block would need more shared memory than sm_90 gives a block;
// the entry points then return cudaErrorInvalidValue.
#pragma once

#include <cuda_runtime.h>

#include "rollout_core.cuh"

namespace ctt {

constexpr int kMaxLayers = 8;        // ops/kernels.py MAX_LAYERS
constexpr int kChunk = 8;            // MLP outputs per pass
constexpr long kMaxSmem = 232448;    // shared memory one block may use on sm_90
enum NetKind : int { kNetMLP = 0, kNetGRU = 1, kNetLSTM = 2 };  // ops/kernels.py NET_KINDS

// The net as the wrapper passes it (ops/kernels.py NetArgs): its form and
// the device pointers of its tensors as stored.
struct NetArgs {
  int kind, n_layers, predict_delta;
  int dims[kMaxLayers + 1];  // MLP: [in, d1, .., out]; recurrent: [in, Hd_1, .., Hd_L]
  const float* w[kMaxLayers];       // MLP w_i [d_i, d_i+1]; cell wi [d_i, G*Hd]
  const float* b[kMaxLayers];       // MLP b_i; cell bi [G*Hd]
  const float* wh[kMaxLayers];      // cell wh [Hd, G*Hd]
  const float* bh[kMaxLayers];      // cell bh [G*Hd]
  const float* hidden[kMaxLayers];  // the live batch-1 hidden: [Hd] (GRU), [h, c] (LSTM)
  const float* wo;                  // head [Hd_L, S]
  const float* bo;
  const float* norm_in_mean;        // MLP norms [S+U] and [S], null when absent
  const float* norm_in_std;
  const float* norm_out_mean;
  const float* norm_out_std;
};

// Offsets (floats) of the staged net in shared memory, and of each
// thread's columns (in columns; column c starts at n_staged + c*kThreads).
struct NetLayout {
  int w[kMaxLayers], b[kMaxLayers], ld[kMaxLayers];  // forward rows, padded
  int wt[kMaxLayers], ldt[kMaxLayers];               // MLP transposed
  int norm[4];                                       // in mean, in std, out mean, out std; -1
  int n_staged;
  int in_col, out_col, act_col[kMaxLayers], ga_col, gb_col;
  int n_cols;
};

__host__ __device__ inline int pad_to(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int gates_of(int kind) { return kind == kNetGRU ? 3 : 4; }

// Lay out `a` for a plant of S states and U controls; `transposed` adds
// the transposed matrices and gradient columns.  Returns the dynamic
// shared memory in bytes, or -1 for a net the kernels refuse.
inline long plan_layout(const NetArgs& a, int S, int U, bool transposed, NetLayout& L) {
  int off = 0, cols = 0, widest = S + U;
  auto take = [&off](int n) { const int o = off; off += pad_to(n, 4); return o; };
  auto column = [&cols](int n) { const int c = cols; cols += n; return c; };
  const int n = a.n_layers;
  if (a.kind != kNetMLP || n < 1 || n > kMaxLayers || a.dims[0] != S + U || a.dims[n] != S) {
    return -1;
  }
  for (int i = 1; i <= n; ++i) {
    if (a.dims[i] < 1) return -1;
    widest = a.dims[i] > widest ? a.dims[i] : widest;
  }
  for (int i = 0; i < 4; ++i) L.norm[i] = -1;
  L.in_col = column(S + U);
  for (int i = 0; i < n; ++i) {
    L.ld[i] = pad_to(a.dims[i + 1], kChunk);
    L.w[i] = take(a.dims[i] * L.ld[i]);
    L.b[i] = take(L.ld[i]);
    if (transposed) {
      L.ldt[i] = pad_to(a.dims[i], kChunk);
      L.wt[i] = take(a.dims[i + 1] * L.ldt[i]);
    }
    if (i < n - 1) L.act_col[i] = column(a.dims[i + 1]);
  }
  if ((a.norm_in_mean == nullptr) != (a.norm_in_std == nullptr) ||
      (a.norm_out_mean == nullptr) != (a.norm_out_std == nullptr)) {
    return -1;
  }
  if (a.norm_in_mean) {
    L.norm[0] = take(S + U);
    L.norm[1] = take(S + U);
  }
  if (a.norm_out_mean) {
    L.norm[2] = take(S);
    L.norm[3] = take(S);
  }
  L.out_col = column(S);
  if (transposed) {
    L.ga_col = column(widest);
    L.gb_col = column(widest);
  }
  L.n_staged = off;
  L.n_cols = cols;
  const long bytes = 4L * (off + static_cast<long>(cols) * kThreads);
  return bytes <= kMaxSmem ? bytes : -1;
}

// ---- staging ---------------------------------------------------------------

// dst [rows, G*np] <- src [rows, G*n]: each of a row's G blocks of n values
// padded with zeros to np.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows,
                                           int G, int n, int np) {
  const int len = rows * G * np;
  for (int idx = threadIdx.x; idx < len; idx += blockDim.x) {
    const int r = idx / (G * np), rem = idx - r * G * np;
    const int g = rem / np, j = rem - g * np;
    dst[idx] = j < n ? __ldg(src + (static_cast<size_t>(r) * G + g) * n + j) : 0.0f;
  }
}

// dst [cols, ldt] <- src [rows, cols] transposed, rows padded with zeros.
__device__ __forceinline__ void stage_transposed(float* dst, const float* __restrict__ src,
                                                 int rows, int cols, int ldt) {
  const int len = cols * ldt;
  for (int idx = threadIdx.x; idx < len; idx += blockDim.x) {
    const int c = idx / ldt, r = idx - c * ldt;
    dst[idx] = r < rows ? __ldg(src + static_cast<size_t>(r) * cols + c) : 0.0f;
  }
}

// Stage the whole net; the caller then synchronises the block.
__device__ __forceinline__ void stage_net(float* sm, const NetArgs& a, const NetLayout& L,
                                          int S, int U, bool transposed) {
  const int n = a.n_layers;
  for (int i = 0; i < n; ++i) {
    stage_rows(sm + L.w[i], a.w[i], a.dims[i], 1, a.dims[i + 1], L.ld[i]);
    stage_rows(sm + L.b[i], a.b[i], 1, 1, a.dims[i + 1], L.ld[i]);
    if (transposed) stage_transposed(sm + L.wt[i], a.w[i], a.dims[i], a.dims[i + 1], L.ldt[i]);
  }
  const float* norms[4] = {a.norm_in_mean, a.norm_in_std, a.norm_out_mean, a.norm_out_std};
  for (int i = 0; i < 4; ++i) {
    const int width = i < 2 ? S + U : S;
    if (L.norm[i] >= 0) stage_rows(sm + L.norm[i], norms[i], 1, 1, width, width);
  }
}

// This thread's column array starting at column c (element i at [i * kThreads]).
__device__ __forceinline__ float* column(float* sm, const NetLayout& L, int c) {
  return sm + L.n_staged + c * kThreads + threadIdx.x;
}

// ---- layers ----------------------------------------------------------------

// y[o] = f(sum_i x[i] * W[i*ld + o] (+ b[o])) for o < n_out, f = tanh or
// identity; x and y column arrays, W and b staged (b may be null), ld a
// multiple of kChunk.  The sum starts at 0 and the bias is added after it,
// as in `a @ W + b`.
template <bool kTanh>
__device__ __forceinline__ void dense(const float* x, int n_in, const float* W, const float* b,
                                      int ld, int n_out, float* y) {
  for (int o0 = 0; o0 < n_out; o0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) acc[q] = 0.0f;
    for (int i = 0; i < n_in; ++i) {
      const float xi = x[i * kThreads];
      const float4* w = reinterpret_cast<const float4*>(W + i * ld + o0);
#pragma unroll
      for (int v = 0; v < kChunk / 4; ++v) {
        const float4 w4 = w[v];
        acc[4 * v + 0] = fmaf(xi, w4.x, acc[4 * v + 0]);
        acc[4 * v + 1] = fmaf(xi, w4.y, acc[4 * v + 1]);
        acc[4 * v + 2] = fmaf(xi, w4.z, acc[4 * v + 2]);
        acc[4 * v + 3] = fmaf(xi, w4.w, acc[4 * v + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (o0 + q < n_out) {
        const float v = b ? acc[q] + b[o0 + q] : acc[q];
        y[(o0 + q) * kThreads] = kTanh ? tanhf(v) : v;
      }
    }
  }
}

// The MLP transition (pallas_neural.py:234-241, NeuralPredictor.single_step)
// in JAX's order: [x, u] through norm_in ((a - mean) / std), each layer
// a @ W + b with tanh on all but the last, norm_out (a * std + mean), then
// x + a (predict_delta) or a.
template <int S, int U>
__device__ __forceinline__ void mlp_step(float* sm, const NetArgs& a, const NetLayout& L,
                                         float (&x)[S], const float (&u)[U]) {
  float* in = column(sm, L, L.in_col);
#pragma unroll
  for (int i = 0; i < S; ++i) in[i * kThreads] = x[i];
#pragma unroll
  for (int j = 0; j < U; ++j) in[(S + j) * kThreads] = u[j];
  if (L.norm[0] >= 0) {
    for (int i = 0; i < S + U; ++i) {
      in[i * kThreads] = (in[i * kThreads] - sm[L.norm[0] + i]) / sm[L.norm[1] + i];
    }
  }
  const float* prev = in;
  const int n = a.n_layers;
  for (int l = 0; l < n - 1; ++l) {
    float* act = column(sm, L, L.act_col[l]);
    dense<true>(prev, a.dims[l], sm + L.w[l], sm + L.b[l], L.ld[l], a.dims[l + 1], act);
    prev = act;
  }
  float* out = column(sm, L, L.out_col);
  dense<false>(prev, a.dims[n - 1], sm + L.w[n - 1], sm + L.b[n - 1], L.ld[n - 1], S, out);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float o = out[i * kThreads];
    if (L.norm[2] >= 0) o = o * sm[L.norm[3] + i] + sm[L.norm[2] + i];
    x[i] = a.predict_delta ? x[i] + o : o;
  }
}

// Set the kernel's dynamic shared memory limit where it exceeds the 48 KB
// default, once per size; returns the CUDA error.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, long bytes, long& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace ctt

// Dynamic shared memory (bytes) a network-rollout kernel's block takes for
// `net` on a plant of S states and U controls (with the transposed layout),
// or -1 for a net the kernels refuse.
extern "C" long ctt_net_smem_bytes(const ctt::NetArgs* net, int S, int U, int transposed);
