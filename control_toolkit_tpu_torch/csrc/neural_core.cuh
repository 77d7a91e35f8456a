// The net's description that every network kernel takes (K8, K9, K11,
// K12, K13; the GP kernels reuse its staging and shared-memory helpers).
// The kernels run their products on tensor cores over these tensors: K8 and
// K9 through mlp_mma.cuh, K11 and K12 through mlp_units.cuh, K13 through
// rnn_mma.cuh.  The net's tensors arrive as they are stored (w [in, out]):
// no copy or transpose is dispatched per call, and a new weight tensor is a
// new pointer, never a rebuild.
#pragma once

#include <cuda_runtime.h>

#include "rollout_core.cuh"

namespace ctt {

constexpr int kMaxLayers = 8;        // ops/kernels.py MAX_LAYERS
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
  const float* hidden[kMaxLayers];  // hidden rows, one a session: [Hd] (GRU), [h, c] (LSTM)
  const float* wo;                  // head [Hd_L, S]
  const float* bo;
  const float* norm_in_mean;        // MLP norms [S+U] and [S], null when absent
  const float* norm_in_std;
  const float* norm_out_mean;
  const float* norm_out_std;
};

__host__ __device__ inline int pad_to(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int gates_of(int kind) { return kind == kNetGRU ? 3 : 4; }

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

// Dynamic shared memory (bytes) a block of the forward network kernel of
// `net`'s kind takes on a plant of S states and U controls (an MLP: K11's
// layout at the plan's warps, mlp_units.cuh; a GRU or LSTM: K13's,
// rnn_mma.cuh), or -1 for a net the kernel refuses.
extern "C" long ctt_net_smem_bytes(const ctt::NetArgs* net, int S, int U);
