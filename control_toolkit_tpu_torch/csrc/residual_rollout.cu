// K12 and K9: rollout + trajectory cost (K12), and the cost J with its
// gradient dJ/dQ in one forward-store / backward-sweep pass (K9), over K
// control sequences under the residual "ODE+res" model
//   x' = ode_step(x, u) + mlp([x, u]).
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_residual_cost_rollout_kernel (K12) and ops/pallas_grad.py:
// build_residual_grad_cost_rollout_kernel (K9; body _make_fwd_bwd_kernel,
// runner _make_grad_runner), the kernels behind kernel_families/residual.py.
// Python wrappers and plain versions: ops/residual_rollout.py and
// ops/residual_grad_cost_rollout.py.
//
// K12 is K1 (cost_rollout.cu) with the residual added to each step: the
// base's euler/rk4 step (rollout_core.cuh integrate) over the packed
// constants p + 0, the cost over p + CartpolePlant::kCost, and the MLP
// (neural_core.cuh mlp_step, absolute form, no norms) on the step's start
// state, staged into shared memory by neural_core.cuh stage_net.  The stage cost
// is taken before the step; cost[k] = (sum_h stage + terminal) / (H+1).
//
// K9 is K7 (grad_cost_rollout.cu) with the same step, its MLP on tensor
// cores (mlp_mma.cuh, as K8's): the forward sweep stores x_h in the
// wrapper-allocated xhist [H, S, K] (rollout index fastest), then
// h = H-1 .. 0 with ct = 1/(H+1):
//   lam = ct * d terminal / d x_H
//   (dx, du) = integrate_vjp + mlp_mma_vjp at the stored x_h, base first
//   (gx, gu, gprev_h) = the stage cost's gradient at ct
//   dQ[k,h] = (du + gu) + gprev_{h+1}       gprev_H = 0
//   lam = dx + gx
// transcribed from ops/adjoints.py residual_step_vjp; the rk4 step and its
// adjoint are rollout_core.cuh's, as K7's.
//
// What bounds K9 on an H100 at the main path's K=16384, H=50.  In FP32,
// K7's rk4 and its transposed step with the stage cost and its gradient
// (665 operations a step) plus the residual MLP's (5-32-32-4) forward and
// transposed layers (5,580): 5.1 GFLOP a call, 0.0764 ms at 67 TFLOP/s
// (chip_smoke.py's bound).  On tensor cores the MLP's three passes
// (forward, re-run without its last layer, transposed), padded to 8 and
// at 3x for the split, are 21 GFLOP of mma, 0.043 ms at 495 TFLOP/s, and
// with the scalar work (the rk4 chain, costs, biases, tanh) at the FP32
// rate 0.057 ms (tc_bound_ms).  The MLP's design is mlp_mma.cuh's (K12
// keeps neural_core.cuh's dense path); the rk4 step and its adjoint run
// on every lane, lanes l and l+16 both for rollout l.  As K8, K9 is bound
// in practice by each warp's own chain of dependent work, here K7's rk4
// chain (K7: 0.303 ms at the same shapes) and the MLP's mma and tanhf in
// turn, with two warps a scheduler: its time is flat from K=2048 to 16384.
#include "mlp_mma.cuh"
#include "neural_core.cuh"

namespace ctt {

// One residual step on x: the MLP on (x, u), the base's step, their sum.
template <class Plant>
__device__ __forceinline__ void residual_step(float* sm, const NetArgs& net, const NetLayout& L,
                                              float (&x)[Plant::S], const float (&u)[Plant::U],
                                              const float* p, const StepConsts& c) {
  constexpr int S = Plant::S, U = Plant::U;
  float a[S];
#pragma unroll
  for (int i = 0; i < S; ++i) a[i] = x[i];
  mlp_step<S, U>(sm, net, L, a, u);  // absolute form: a = mlp([x, u])
  integrate<Plant>(x, u, p, c);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x[i] + a[i];
}

template <class Plant>
__global__ void __launch_bounds__(kThreads)
residual_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                             const float* __restrict__ pvec, float* __restrict__ cost, int K,
                             int H, StepConsts c, float max_cost, NetArgs net, NetLayout L) {
  constexpr int S = Plant::S, U = Plant::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_net(sm, net, L, S, U, false);
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  Rollout<Plant> r;
  r.start(s0 + static_cast<size_t>(k) * S, p);
  const float* q = Q + static_cast<size_t>(k) * H * U;
  for (int h = 0; h < H; ++h) {
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    r.acc = r.acc + Plant::stage_cost(r.x, u, r.prev, p, max_cost);
    residual_step<Plant>(sm, net, L, r.x, u, p, c);
#pragma unroll
    for (int j = 0; j < U; ++j) r.prev[j] = u[j];
  }
  cost[k] = r.finish(p, H);
}

template <class Plant>
__global__ void __launch_bounds__(kMmaThreads, 1)
residual_grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                  const float* __restrict__ pvec, float* __restrict__ cost,
                                  float* __restrict__ dQ, float* __restrict__ xhist, int K, int H,
                                  StepConsts c, float max_cost, float ct, NetArgs net,
                                  MmaLayout L) {
  constexpr int S = Plant::S, U = Plant::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_mma_net(sm, net, L, S, U);
  __syncthreads();
  const WarpRows rows(K);
  if (rows.first >= K) return;  // the whole warp past K
  const int k = rows.k;
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  const float* q = Q + static_cast<size_t>(rows.kc) * H * U;
  float* dq = dQ + static_cast<size_t>(k) * H * U;

  // Forward sweep.
  Rollout<Plant> r;
  r.start(s0 + static_cast<size_t>(rows.kc) * S, p);
  for (int h = 0; h < H; ++h) {
    if (rows.writes) {
#pragma unroll
      for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(h) * S + i) * K + k] = r.x[i];
    }
    float u[U], a[S];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    r.acc = r.acc + Plant::stage_cost(r.x, u, r.prev, p, max_cost);
    mlp_mma_step<S, U>(sm, net, L, r.x, u, a);  // absolute form: a = mlp([x, u])
    integrate<Plant>(r.x, u, p, c);
#pragma unroll
    for (int i = 0; i < S; ++i) r.x[i] = r.x[i] + a[i];
#pragma unroll
    for (int j = 0; j < U; ++j) r.prev[j] = u[j];
  }
  if (rows.writes) cost[k] = r.finish(p, H);

  // Backward sweep.
  float lam[S], gnext[U];
  Plant::terminal_cost_grad(r.x, p, ct, lam);
#pragma unroll
  for (int j = 0; j < U; ++j) gnext[j] = 0.0f;
  for (int h = H - 1; h >= 0; --h) {
    float x[S], u[U], prev[U];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      x[i] = __shfl_sync(0xffffffffu, xhist[(static_cast<size_t>(h) * S + i) * K + rows.kc],
                         threadIdx.x & 15);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = __ldg(q + h * U + j);
      prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : p[Plant::kUPrev + j];
    }
    float dx_res[S], du_res[U], du[U], gx[S], gu[U], gp[U];
    mlp_mma_vjp<S, U>(sm, net, L, x, u, lam, dx_res, du_res);  // lam unchanged
    integrate_vjp<Plant>(x, u, p, c, lam, du);                  // lam: now the base's dx
    Plant::stage_cost_vjp(x, u, prev, p, ct, gx, gu, gp);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (rows.writes) dq[h * U + j] = ((du[j] + du_res[j]) + gu[j]) + gnext[j];
      gnext[j] = gp[j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = (lam[i] + dx_res[i]) + gx[i];
  }
}

// The residual nets the kernels take: an MLP in absolute form without norms.
inline bool residual_net(const NetArgs& net) {
  return net.kind == kNetMLP && net.predict_delta == 0 && !net.norm_in_mean && !net.norm_out_mean;
}

// The dynamic shared memory K9's attribute allows so far (allow_smem).
static long k9_allowed = 0;

// Plan the net's layout, allow the shared memory and launch K12.
template <class Kernel, class... Args>
int launch_residual(Kernel kernel, long& allowed, const NetArgs& net, int K, void* stream,
                    Args... args) {
  using Plant = CartpolePlant;
  NetLayout L;
  if (!residual_net(net)) return static_cast<int>(cudaErrorInvalidValue);
  const long bytes = plan_layout(net, Plant::S, Plant::U, false, L);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args..., net, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Launches K12 on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unknown plant or a net the kernel refuses (not
// an MLP in absolute form without norms, or too large for shared memory).
extern "C" int ctt_residual_cost_rollout(int plant, const void* s0, const void* Q,
                                         const void* pvec, void* cost, int K, int H, int rk4,
                                         int substeps, float sub_dt, float half_dt, float dt6,
                                         float max_cost, const ctt::NetArgs* net, void* stream) {
  static long allowed = 0;
  if (plant != ctt::kPlantCartpole) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  return ctt::launch_residual(ctt::residual_cost_rollout_kernel<ctt::CartpolePlant>, allowed,
                             *net, K, stream, static_cast<const float*>(s0),
                             static_cast<const float*>(Q), static_cast<const float*>(pvec),
                             static_cast<float*>(cost), K, H, c, max_cost);
}

// Launches K9 on `stream`; returns as above.  xhist is scratch of H*S*K
// floats that the caller allocates.
extern "C" int ctt_residual_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                              const void* pvec, void* cost, void* dQ,
                                              void* xhist, int K, int H, int rk4, int substeps,
                                              float sub_dt, float half_dt, float dt6,
                                              float max_cost, float ct, const ctt::NetArgs* net,
                                              void* stream) {
  using Plant = ctt::CartpolePlant;
  if (plant != ctt::kPlantCartpole || !ctt::residual_net(*net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  return ctt::launch_mma(ctt::residual_grad_cost_rollout_kernel<Plant>, ctt::k9_allowed, *net,
                         Plant::S, Plant::U, K, stream, static_cast<const float*>(s0),
                         static_cast<const float*>(Q), static_cast<const float*>(pvec),
                         static_cast<float*>(cost), static_cast<float*>(dQ),
                         static_cast<float*>(xhist), K, H, c, max_cost, ct);
}

// Blocks of K9 an SM holds for `net` (0 for a net it refuses).
extern "C" int ctt_residual_grad_blocks_per_sm(const ctt::NetArgs* net) {
  using Plant = ctt::CartpolePlant;
  if (!ctt::residual_net(*net)) return 0;
  return ctt::mma_blocks_per_sm(ctt::residual_grad_cost_rollout_kernel<Plant>, ctt::k9_allowed,
                                *net, Plant::S, Plant::U);
}
