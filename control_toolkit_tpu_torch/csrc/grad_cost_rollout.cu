// K7: rollout cost J and its gradient dJ/dQ over K control sequences, in
// one forward-store / backward-sweep pass per rollout.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_grad_cost_rollout_kernel
// (body _make_fwd_bwd_kernel, runner _make_grad_runner; the kernel behind
// kernel_families/ode.py:build_grad).  Python wrapper and plain version:
// ops/grad_cost_rollout.py.  The Pallas kernel got its backward from
// jax.vjp at trace time; here the adjoints are written by hand
// (plants.cuh derivs_vjp / stage_cost_vjp / terminal_cost_grad,
// rollout_core.cuh integrate_vjp), transcribed from ops/adjoints.py.
//
// Forward (bit for bit K1's arithmetic): store x_h, add the stage cost,
// integrate; cost[k] = (sum_h stage + terminal) / (H+1).
// Backward, h = H-1 .. 0, with ct = 1/(H+1):
//   lam = ct * d terminal / d x_H
//   (dx, du) = integrate_vjp at the stored x_h (the step is re-run)
//   (gx, gu, gprev_h) = the stage cost's gradient at ct
//   dQ[k,h] = (du + gu) + gprev_{h+1}       gprev_H = 0
//   lam = dx + gx
// prev at h = 0 is the packed __u_prev, which gets no gradient.
//
// State history: one thread owns one rollout, and its H states go to the
// wrapper-allocated scratch xhist [H, S, K], rollout index fastest, so a
// warp's stores and loads of one (h, i) are 128 contiguous bytes.  At
// K=16384, H=50, S=4 that is 13.1 MB, which the H100's 50 MB L2 holds
// between the two sweeps.  A per-thread array of H*S = 200 floats would
// spill to local memory instead.
//
// Q and dQ stay in their [K, H, U] layout, read and written strided (thread
// k walks row k), as K1 reads Q: a warp's access at step h touches 32
// sectors, but each 32-byte sector holds 8 consecutive steps of one
// rollout, which the next iterations find in L1 (reads) or merge in L2
// (writes); a transpose to [H, U, K] in the wrapper, as _make_grad_runner
// does for the TPU's lane layout, would add two passes over Q and dQ.
//
// What bounds it on an H100: the dependent FP32 chain per thread, about
// twice K1's: the forward rk4 (four plant evaluations per step), then per
// step in the backward the re-run of three of them and four transposed
// plant evaluations, each with sinf, cosf and divisions.  At K=16384 the
// grid is 128 blocks of 128 threads on 132 SMs, about four warps per SM,
// too few to hide that chain's latency; the history traffic (2 x 13.1 MB,
// mostly L2) is secondary.  The design does nothing about either yet: a
// first, simple kernel.
#include "rollout_core.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kThreads)
grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                         const float* __restrict__ pvec, float* __restrict__ cost,
                         float* __restrict__ dQ, float* __restrict__ xhist, int K, int H,
                         StepConsts c, float max_cost, float ct) {
  constexpr int S = Plant::S, U = Plant::U;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  const float* q = Q + static_cast<size_t>(k) * H * U;
  float* dq = dQ + static_cast<size_t>(k) * H * U;

  // Forward sweep.
  Rollout<Plant> r;
  r.start(s0 + static_cast<size_t>(k) * S, p);
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(h) * S + i) * K + k] = r.x[i];
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    r.advance(u, p, c, max_cost);
  }
  cost[k] = r.finish(p, H);

  // Backward sweep.
  float lam[S], gnext[U];
  Plant::terminal_cost_grad(r.x, p, ct, lam);
#pragma unroll
  for (int j = 0; j < U; ++j) gnext[j] = 0.0f;
  for (int h = H - 1; h >= 0; --h) {
    float x[S], u[U], prev[U];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xhist[(static_cast<size_t>(h) * S + i) * K + k];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = __ldg(q + h * U + j);
      prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : p[Plant::kUPrev + j];
    }
    float du[U], gx[S], gu[U], gp[U];
    integrate_vjp<Plant>(x, u, p, c, lam, du);  // lam: now dx
    Plant::stage_cost_vjp(x, u, prev, p, ct, gx, gu, gp);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      dq[h * U + j] = (du[j] + gu[j]) + gnext[j];
      gnext[j] = gp[j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = lam[i] + gx[i];
  }
}

}  // namespace ctt

// Launches K7 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).  xhist is scratch of
// H*S*K floats that the caller allocates.
extern "C" int ctt_grad_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                     void* cost, void* dQ, void* xhist, int K, int H, int rk4,
                                     int substeps, float sub_dt, float half_dt, float dt6,
                                     float max_cost, float ct, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      ctt::grad_cost_rollout_kernel<ctt::CartpolePlant><<<grid, ctt::kThreads, 0, st>>>(
          static_cast<const float*>(s0), static_cast<const float*>(Q),
          static_cast<const float*>(pvec), static_cast<float*>(cost), static_cast<float*>(dQ),
          static_cast<float*>(xhist), K, H, c, max_cost, ct);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
