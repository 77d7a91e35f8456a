// K8: rollout cost J under an MLP and its gradient dJ/dQ over K control
// sequences, in one forward-store / backward-sweep pass per rollout.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:
// build_neural_grad_cost_rollout_kernel (body _make_fwd_bwd_kernel, runner
// _make_grad_runner; the kernel behind kernel_families/neural.py:
// build_grad).  Python wrapper and plain version:
// ops/neural_grad_cost_rollout.py.  It is K7 (grad_cost_rollout.cu) with
// the MLP step (neural_core.cuh mlp_step / mlp_step_vjp, transcribed from
// ops/adjoints.py mlp_step_vjp) in place of the integrator; the cost's
// adjoints are plants.cuh CartpoleCost's.  The Pallas kernel transposed
// the step with jax.vjp at trace time.
//
// Forward (K11's arithmetic): store x_h, add the stage cost, step;
// cost[k] = (sum_h stage + terminal) / (H+1).  Backward, h = H-1 .. 0, with
// ct = 1/(H+1):
//   lam = ct * d terminal / d x_H
//   (dx, du) = mlp_step_vjp at the stored x_h (the step is re-run)
//   (gx, gu, gprev_h) = the stage cost's gradient at ct
//   dQ[k,h] = (du + gu) + gprev_{h+1}       gprev_H = 0
//   lam = dx + gx
//
// The states go to the wrapper-allocated scratch xhist [H, S, K], rollout
// index fastest, as in K7 (13.1 MB at K=16384, H=50, inside the 50 MB L2).
// The block stages each matrix twice, as stored and transposed, so the
// backward's g @ W^T is the forward's loop; each thread keeps its hidden
// activations (for tanh') and two gradient columns in shared memory.
//
// What bounds it on an H100: FP32 multiply-adds, about three times K11's
// (the forward, the re-run and the transposed layers): ~23 GFLOP a call
// for mlp-64-64 at K=16384, H=50, 0.34 ms at the 67 TFLOP/s peak, with the
// same four warps per SM and shared-memory operands as K11, so it runs far
// from that bound.  A first, simple kernel.
#include "neural_core.cuh"

namespace ctt {

template <class Cost>
__global__ void __launch_bounds__(kThreads)
neural_grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                const float* __restrict__ pvec, float* __restrict__ cost,
                                float* __restrict__ dQ, float* __restrict__ xhist, int K, int H,
                                float max_cost, float ct, NetArgs net, NetLayout L) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_net(sm, net, L, S, U, true);
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
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
    mlp_step<S, U>(sm, net, L, x, u);
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
    float dx[S], du[U], gx[S], gu[U], gp[U];
    mlp_step_vjp<S, U>(sm, net, L, xh, u, lam, dx, du);
    Cost::stage_cost_vjp(xh, u, prev, c, ct, gx, gu, gp);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      dq[h * U + j] = (du[j] + gu[j]) + gnext[j];
      gnext[j] = gp[j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = dx[i] + gx[i];
  }
}

}  // namespace ctt

// Launches K8 on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown plant or a net the kernel refuses.
// xhist is scratch of H*S*K floats that the caller allocates.
extern "C" int ctt_neural_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                            const void* pvec, void* cost, void* dQ, void* xhist,
                                            int K, int H, float max_cost, float ct,
                                            const ctt::NetArgs* net, void* stream) {
  using Cost = ctt::CartpoleCost;
  static long allowed = 0;
  if (plant != ctt::kPlantCartpole || net->kind != ctt::kNetMLP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ctt::NetLayout L;
  const long bytes = ctt::plan_layout(*net, Cost::S, Cost::U, true, L);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ctt::neural_grad_cost_rollout_kernel<Cost>;
  const cudaError_t err = ctt::allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  kernel<<<grid, ctt::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(Q),
      static_cast<const float*>(pvec), static_cast<float*>(cost), static_cast<float*>(dQ),
      static_cast<float*>(xhist), K, H, max_cost, ct, *net, L);
  return static_cast<int>(cudaGetLastError());
}
