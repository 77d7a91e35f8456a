// K14 and K10: rollout + trajectory cost (K14), and the cost J with its
// gradient dJ/dQ in one forward-store / backward-sweep pass (K10), over K
// control sequences under sparse-GP dynamics (gp_core.cuh).
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_gp_cost_rollout_kernel (K14) and ops/pallas_grad.py:
// build_gp_grad_cost_rollout_kernel (K10), the kernels behind
// kernel_families/gp.py.  Python wrappers and plain versions:
// ops/gp_rollout.py and ops/gp_grad_cost_rollout.py.
//
// K14 is K11 (neural_rollout.cu) with the GP step: the packed parameters
// are the cost's alone (plants.cuh CartpoleCost), the stage cost is taken
// before the step, cost[k] = (sum_h stage + terminal) / (H+1).  K10 is K7
// (grad_cost_rollout.cu) with the GP step and its adjoint (gp_core.cuh
// gp_step_vjp, transcribed from ops/adjoints.py gp_step_vjp): the forward
// sweep stores x_h in the wrapper-allocated xhist [H, S, K], then
// h = H-1 .. 0 with ct = 1/(H+1):
//   lam = ct * d terminal / d x_H
//   (dx, du) = gp_step_vjp at the stored x_h (the RBF row recomputed)
//   (gx, gu, gprev_h) = the stage cost's gradient at ct
//   dQ[k,h] = (du + gu) + gprev_{h+1}       gprev_H = 0
//   lam = dx + gx
//
// What bounds them on an H100: per rollout-step, a loop over the M inducing
// points, each a D-term dot product, an exp and S multiply-adds (about 25
// FP32 operations; K10's backward about 55 more); at the main path's
// K=16384, H=50, M=128 that is 2.6 GFLOP a call for K14 (0.04 ms at the
// 67 TFLOP/s FP32 peak) and about 8.5 GFLOP for K10.  The inducing points
// (M * 12 floats, 6 KB at M=128) are read from shared memory as warp-wide
// broadcasts, so the loop is a dependent FP32 chain per thread with one
// rollout per thread, about four warps per SM: latency-bound, far from the
// peak.  A first, simple kernel.
#include "gp_core.cuh"

namespace ctt {

template <class Cost>
__global__ void __launch_bounds__(kThreads)
gp_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                       const float* __restrict__ pvec, float* __restrict__ cost, int K, int H,
                       float max_cost, GPArgs gp) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_gp<S, U>(sm, gp);
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  GPConsts<S, U> g;
  g.load(gp);
  float c[Cost::kN];
#pragma unroll
  for (int i = 0; i < Cost::kN; ++i) c[i] = __ldg(pvec + i);
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(k) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = c[Cost::kUPrev + j];
  const float* q = Q + static_cast<size_t>(k) * H * U;
  for (int h = 0; h < H; ++h) {
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    acc = acc + Cost::stage_cost(x, u, prev, c, max_cost);
    gp_step<S, U>(sm, gp.M, g, x, u);
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);
}

template <class Cost>
__global__ void __launch_bounds__(kThreads)
gp_grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                            const float* __restrict__ pvec, float* __restrict__ cost,
                            float* __restrict__ dQ, float* __restrict__ xhist, int K, int H,
                            float max_cost, float ct, GPArgs gp) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_gp<S, U>(sm, gp);
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  GPConsts<S, U> g;
  g.load(gp);
  float c[Cost::kN];
#pragma unroll
  for (int i = 0; i < Cost::kN; ++i) c[i] = __ldg(pvec + i);
  const float* q = Q + static_cast<size_t>(k) * H * U;
  float* dq = dQ + static_cast<size_t>(k) * H * U;

  // Forward sweep.
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(k) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = c[Cost::kUPrev + j];
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(h) * S + i) * K + k] = x[i];
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    acc = acc + Cost::stage_cost(x, u, prev, c, max_cost);
    gp_step<S, U>(sm, gp.M, g, x, u);
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);

  // Backward sweep.
  float lam[S], gnext[U];
  Cost::terminal_cost_grad(x, c, ct, lam);
#pragma unroll
  for (int j = 0; j < U; ++j) gnext[j] = 0.0f;
  for (int h = H - 1; h >= 0; --h) {
    float xh[S], u[U];
#pragma unroll
    for (int i = 0; i < S; ++i) xh[i] = xhist[(static_cast<size_t>(h) * S + i) * K + k];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = __ldg(q + h * U + j);
      prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : c[Cost::kUPrev + j];
    }
    float dx[S], du[U], gx[S], gu[U], gp_[U];
    gp_step_vjp<S, U>(sm, gp.M, g, xh, u, lam, dx, du);
    Cost::stage_cost_vjp(xh, u, prev, c, ct, gx, gu, gp_);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      dq[h * U + j] = (du[j] + gu[j]) + gnext[j];
      gnext[j] = gp_[j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = dx[i] + gx[i];
  }
}

// Size the shared memory, allow it and launch `kernel`.
template <class Kernel, class... Args>
int launch_gp(Kernel kernel, long& allowed, const GPArgs& gp, int K, void* stream,
              Args... args) {
  using Cost = CartpoleCost;
  const long bytes = gp_smem_bytes<Cost::S, Cost::U>(gp.M);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args..., gp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Dynamic shared memory (bytes) a GP kernel's block takes for M inducing
// points on a plant of S states and U controls, or -1 where it refuses M.
extern "C" long ctt_gp_smem_bytes(int S, int U, int M) {
  if (S != ctt::CartpoleCost::S || U != ctt::CartpoleCost::U) return -1;
  return ctt::gp_smem_bytes<ctt::CartpoleCost::S, ctt::CartpoleCost::U>(M);
}

// Launches K14 on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown plant or an M whose inducing points
// exceed a block's shared memory.
extern "C" int ctt_gp_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                   void* cost, int K, int H, float max_cost,
                                   const ctt::GPArgs* gp, void* stream) {
  static long allowed = 0;
  if (plant != ctt::kPlantCartpole) return static_cast<int>(cudaErrorInvalidValue);
  return ctt::launch_gp(ctt::gp_cost_rollout_kernel<ctt::CartpoleCost>, allowed, *gp, K, stream,
                        static_cast<const float*>(s0), static_cast<const float*>(Q),
                        static_cast<const float*>(pvec), static_cast<float*>(cost), K, H,
                        max_cost);
}

// Launches K10 on `stream`; returns as above.  xhist is scratch of H*S*K
// floats that the caller allocates.
extern "C" int ctt_gp_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                        const void* pvec, void* cost, void* dQ, void* xhist,
                                        int K, int H, float max_cost, float ct,
                                        const ctt::GPArgs* gp, void* stream) {
  static long allowed = 0;
  if (plant != ctt::kPlantCartpole) return static_cast<int>(cudaErrorInvalidValue);
  return ctt::launch_gp(ctt::gp_grad_cost_rollout_kernel<ctt::CartpoleCost>, allowed, *gp, K,
                        stream, static_cast<const float*>(s0), static_cast<const float*>(Q),
                        static_cast<const float*>(pvec), static_cast<float*>(cost),
                        static_cast<float*>(dQ), static_cast<float*>(xhist), K, H, max_cost,
                        ct);
}
