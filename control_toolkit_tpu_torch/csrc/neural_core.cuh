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

// Whether a cost's instances of the network kernels (K8, K11, K13) inline
// the net's step (cartpole's, as they always did) or call one outlined body
// a (S, U) in their source: the network step's unrolled tensor-core code is
// most of a kernel's build.
template <class Cost>
constexpr bool kInlineNet = false;
template <>
constexpr bool kInlineNet<CartpoleCost> = true;

// The network kernels' cost groups, each compiled in sources of their own
// (net_plants_<group>.cu: K11 and K13; neural_grad_plants_<group>.cu: K8),
// by (S, U), so that a source compiles each width's outlined steps once and
// no source's build grows.  The id is the cost's plant (ops/kernels.py: a
// network kernel's plant is its cost's); net_group gives its group (-1:
// none, cartpole's instances among them: they are the entries' own).
inline int net_group(int plant) {
  switch (plant) {
    case kPlantPendulum: case kPlantQuadrotor2D: return 0;  // (2, 1) and (6, 2)
    case kPlantAcrobot: return 1;                            // (4, 1)
    case kPlantPointmass: case kPlantPointmassObstacles: case kPlantCar: return 2;  // (4, 2)
    case kPlantCarObstacles: case kPlantArm2: return 3;     // (4, 2)
    case kPlantQuadrotor3D: return 4;                        // (12, 4)
    default: return -1;
  }
}

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
