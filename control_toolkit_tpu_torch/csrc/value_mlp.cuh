// The learned terminal value V of the gradient kernels' value_spec forms
// (pallas_grad.py:119-141, :186-206): K7's (grad_cost_rollout.cu), K8's
// and its member-block form's (neural_grad_rollout.cu), K9's
// (residual_rollout.cu) and K10's (gp_rollout.cu).  V is a tanh MLP from
// the state to one number, its scale folded into its last layer by the
// caller (Optimizer._flatten_value_ops), and each form computes
//   cost  = (acc + terminal(x_H) + V(x_H)) / (H+1)
//   lam_H = ct * (d terminal / d x_H + dV / d x_H)
// with value_forward_vjp below, one thread a rollout: the block stages the
// net's 2L operands in shared memory once (stage_value_net), and each
// evaluating thread gets a column of a [units][Cols] shared array for its
// hidden activations, which the VJP overwrites with the layers'
// cotangents, last layer first.  The activations sit in shared memory, not
// registers, because the net's widths are run-time values; its tensors
// come in by pointer (ValueArgs) on every call, so a re-fit or a changed
// scale rebuilds nothing.
#pragma once

#include <cuda_runtime.h>

namespace ctt {

constexpr int kMaxValueLayers = 8;  // ops/kernels.py VALUE_MAX_LAYERS

// The net: n_layers layers, dims[0] = S inputs, dims[n_layers] = 1 output,
// layer l w[l] [dims[l], dims[l+1]] row-major and b[l] [dims[l+1]], as
// models/networks.py:mlp_apply reads them (device pointers, as stored).
struct ValueArgs {
  int n_layers;
  int dims[kMaxValueLayers + 1];
  const float* w[kMaxValueLayers];
  const float* b[kMaxValueLayers];
};

__host__ __device__ inline int value_param_floats(const ValueArgs& v) {
  int n = 0;
  for (int l = 0; l < v.n_layers; ++l) n += v.dims[l] * v.dims[l + 1] + v.dims[l + 1];
  return n;
}

__host__ __device__ inline int value_hidden_units(const ValueArgs& v) {
  int n = 0;
  for (int l = 1; l < v.n_layers; ++l) n += v.dims[l];
  return n;
}

// Shared memory for the staged operands and `columns` columns of hidden
// activations.
inline size_t value_smem_bytes(const ValueArgs& v, int columns) {
  return sizeof(float) * (static_cast<size_t>(value_param_floats(v)) +
                          static_cast<size_t>(value_hidden_units(v)) * columns);
}

// Whether the kernels take the net of v for a plant of S states: 1 to
// kMaxValueLayers layers, S inputs, one output, no empty hidden layer.
inline bool value_net_ok(const ValueArgs& v, int S) {
  if (v.n_layers < 1 || v.n_layers > kMaxValueLayers || v.dims[0] != S ||
      v.dims[v.n_layers] != 1) {
    return false;
  }
  for (int l = 1; l < v.n_layers; ++l) {
    if (v.dims[l] < 1) return false;
  }
  return true;
}

// Stage the net's operands (each layer's w then b) to sm with the block's
// threads; the caller then synchronises the block.
__device__ __forceinline__ void stage_value_net(float* sm, const ValueArgs& v) {
  int off = 0;
  for (int l = 0; l < v.n_layers; ++l) {
    const int nw = v.dims[l] * v.dims[l + 1], nb = v.dims[l + 1];
    for (int i = threadIdx.x; i < nw; i += blockDim.x) sm[off + i] = __ldg(v.w[l] + i);
    for (int i = threadIdx.x; i < nb; i += blockDim.x) sm[off + nw + i] = __ldg(v.b[l] + i);
    off += nw + nb;
  }
}

// V(x) of the staged net wsm and ct * dV/dx into gx; act is the thread's
// column of the [units][Cols] activation array: the forward leaves each
// hidden layer's tanh there, the VJP replaces it, last layer first, with
// that layer's cotangent before tanh.
template <int S, int Cols>
__device__ __forceinline__ float value_forward_vjp(const float (&x)[S],
                                                   const float* __restrict__ wsm,
                                                   const ValueArgs& v, float* act, float ct,
                                                   float (&gx)[S]) {
  const int L = v.n_layers;
  int woff = 0, ain = 0;  // layer l's operands in wsm; its input's column offset (l >= 1)
  float out = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int din = v.dims[l], dout = v.dims[l + 1];
    const float* w = wsm + woff;
    const float* bias = w + din * dout;
    const int aout = l == 0 ? 0 : ain + din;
    for (int o = 0; o < dout; ++o) {
      float z = bias[o];
      if (l == 0) {
#pragma unroll
        for (int i = 0; i < S; ++i) z = fmaf(x[i], w[i * dout + o], z);
      } else {
        for (int i = 0; i < din; ++i) z = fmaf(act[(ain + i) * Cols], w[i * dout + o], z);
      }
      if (l + 1 < L) {
        act[(aout + o) * Cols] = tanhf(z);
      } else {
        out = z;  // dout == 1 (the host checks)
      }
    }
    woff += din * dout + dout;
    ain = aout;
  }
  // The VJP: gout is the column offset of layer l's output cotangent.
  int gout = ain;
  for (int l = L - 1; l >= 0; --l) {
    const int din = v.dims[l], dout = v.dims[l + 1];
    woff -= din * dout + dout;
    const float* w = wsm + woff;
    const int gin = l == 0 ? 0 : gout - din;
    auto cotangent = [&](int i) {
      if (l + 1 == L) return w[i] * ct;
      float g = 0.0f;
      for (int o = 0; o < dout; ++o) g = fmaf(w[i * dout + o], act[(gout + o) * Cols], g);
      return g;
    };
    if (l == 0) {
#pragma unroll
      for (int i = 0; i < S; ++i) gx[i] = cotangent(i);
    } else {
      for (int i = 0; i < din; ++i) {
        const float a = act[(gin + i) * Cols];
        act[(gin + i) * Cols] = cotangent(i) * (1.0f - a * a);
      }
    }
    gout = gin;
  }
  return out;
}

// V and ct * dV/dx at the state x that lanes share: lane `src` of them
// evaluates both in its column `col` of the [units][Cols] array after the
// staged operands at vsm, and a shuffle gives every lane that names it its
// bits.  Every lane of the warp must call it.
template <int S, int Cols>
__device__ __forceinline__ float value_from_lane(const float (&x)[S], float* vsm,
                                                 const ValueArgs& v, int src, int col, float ct,
                                                 float (&gx)[S]) {
  float value = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) gx[i] = 0.0f;
  if (static_cast<int>(threadIdx.x & 31) == src) {
    value = value_forward_vjp<S, Cols>(x, vsm, v, vsm + value_param_floats(v) + col, ct, gx);
  }
  value = __shfl_sync(0xffffffffu, value, src);
#pragma unroll
  for (int i = 0; i < S; ++i) gx[i] = __shfl_sync(0xffffffffu, gx[i], src);
  return value;
}

}  // namespace ctt
