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
// K12's emit_terminal form (pallas_neural.py:367, :393, :422-427) serves a
// learned value terminal: the same costs and each rollout's state after
// step H written to x_term [K, S] by the base-step warp's lanes that write
// cost[k], rows past K writing nothing.  It is its own entry over K12's
// body (residual_cost_rollout_emit_kernel, the body's Emit instance) at
// K12's launch bounds, so the unvalued kernel's code stays as it was.
//
// K12 serves one session (ks = K) or, in its session-row form, B sessions
// of ks rollouts in one launch, rollout k reading row k / ks of pvec (the
// session's base constants and cost; both warps of a group read it).  So
// does K9 (pallas_grad.py:474), each lane its rollout's row: a 16-rollout
// warp straddles two sessions whenever ks is not a multiple of 16.
//
// Over the fast base plant (CartpoleFastPlant: "ODE+res:...:fast") each
// entry is instantiated again, its base step's trig polynomial (plants.cuh),
// its cost exact; K9's adjoint then takes the polynomials' derivatives.
//
// Every other ODE base (the pendulum, acrobot, point-mass, quadrotor, car
// and arm plants, with their fast plants; rollout_core.cuh
// with_slice_plant) takes all four forms of both kernels, the same bodies:
// short_step.cuh's step over their integrate, the residual MLP over [x, u]
// of S + U columns.  The 3-D quadrotor's 16 inputs and 12 outputs take two
// lane tiles each way (mlp_mma.cuh io_tiles), and its exchange slots 16
// floats a rollout.  They compile in sources of their own
// (residual_cost_plants.cu, residual_grad_plants_<group>.cu), so that no
// source's build grows.
//
// K12 is K1 (cost_rollout.cu) with the residual added to each step: the
// base's euler/rk4 step over the packed
// constants p + 0, the cost over p + CartpolePlant::kCost, and the MLP
// (absolute form, no norms) on the step's start state.  The stage cost is
// taken before the step; cost[k] = (sum_h stage + terminal) / (H+1).  Its
// MLP is K11's (mlp_units.cuh mlp_units_step: 3xTF32 mma.sync over a
// 16-rollout group, split by unit tile), its stage cost and base step K5's
// (short_step.cuh: derivs_short, one division a plant evaluation).  The
// base step reads only (x_h, u_h), as the MLP does, so the two need not
// wait on each other: a group of two warps (lanes l and l+16 of each own
// rollout l) runs them side by side, warp 0 the MLP and warp 1 the stage
// cost and the base step.  Each warp puts its half of the sum (a, or the
// base's x) into the group's exchange slots, one named barrier a step
// joins them, and both add x' = base + a.  The slots are double-buffered
// by step parity: a warp writes step h+1's slots only after it passed
// step h's barrier, and passes step h+1's only once the other read step
// h's.  Blocks are kResBlockWarps warps (2 groups, fewer where the net's
// shared memory does not allow them), so that the 1,024 groups of K=16384
// spread over all 132 SMs.  (One warp a group, the MLP and then the base
// step, was 3% slower at K=16384 and 15% at K=2048: PERF.md.)
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
// adjoint are rollout_core.cuh's, as K7's.  K9's value_spec form (one
// session or the session-row form; its own entry over K9's body,
// residual_grad_cost_rollout_value_kernel) adds a learned terminal value V
// as K8's does (mlp_mma.cuh value_mma_tail): V(x_H) joins the terminal
// cost and ct * dV/dx_H seeds lam.
//
// What bounds them on an H100 at the main path's K=16384, H=50.  K12 in
// FP32: the rk4 step (172 operations), the stage cost (24) and the
// residual MLP's (5-32-32-4) forward (2,760): 2.4 GFLOP a call, 0.036 ms
// at 67 TFLOP/s; on tensor cores its 24 m16n8k8 tiles a group-step at 3x
// for the split are 7.5 GFLOP of mma (0.015 ms at 495 TFLOP/s), with the
// scalar work at the FP32 rate 0.019 ms (chip_smoke.py's tc_bound_ms).
// In practice each group's serial chain a step bounds it, as K11's: the
// MLP warp's instructions (mma, tanhf, splits and their moves), with the
// base step's chain beside it on the second warp (PERF.md).  K9 in FP32: K7's rk4 and its
// transposed step with the stage cost and its gradient (665 operations a
// step) plus the MLP's forward and transposed layers (5,580): 5.1 GFLOP a
// call, 0.0764 ms; on tensor cores the MLP's three passes (forward,
// re-run without its last layer, transposed), padded to 8 and at 3x for
// the split, are 21 GFLOP of mma, 0.043 ms, and with the scalar work
// 0.057 ms.  The rk4 step and its adjoint run on every lane, lanes l and
// l+16 both for rollout l.  As K8, K9 is bound in practice by each warp's
// own chain of dependent work, here K7's rk4 chain and the MLP's mma and
// tanhf in turn, with two warps a scheduler: its time is flat from K=2048
// to 16384.
//
// This header holds the kernels and their launchers; residual_rollout.cu
// the C entries.
#pragma once

#include <type_traits>

#include "mlp_units.cuh"
#include "short_step.cuh"

namespace ctt {

constexpr int kResBlockWarps = 4;  // warps a K12 block, at most
constexpr int kResGroupWarps = 2;  // warps a K12 group: the MLP's, the base step's

// The residual nets the kernels take: an MLP in absolute form without norms.
inline bool residual_net(const NetArgs& net) {
  return net.kind == kNetMLP && net.predict_delta == 0 && !net.norm_in_mean && !net.norm_out_mean;
}

// The floats a rollout takes in K12's exchange slots: a plant's S, padded
// to 8.
__host__ __device__ constexpr int exchange_width(int S) { return (S + 7) / 8 * 8; }

// Whether the residual kernels' instance over `Plant` inlines the MLP
// (cartpole's two, as before) or calls it (mlp_units_step_call,
// mlp_mma_step_call, mlp_mma_vjp_call: one body per (S, U) in a source,
// shared by the plants of equal widths: the MLP's unrolled tensor-core code
// is most of K9's build, 16 inlined instances 300 s of one nvcc).
template <class Plant>
constexpr bool kInlineMlp = false;
template <>
constexpr bool kInlineMlp<CartpolePlant> = true;
template <>
constexpr bool kInlineMlp<CartpoleFastPlant> = true;

// K12's layout: K11's at one MLP warp a group (mlp_units.cuh), with the
// exchange slots (two steps of two [16, exchange_width(S)] tiles: a, and
// the base's x) at the end of the group's region.
struct ResidualLayout {
  MlpUnitsLayout mlp;
  int xchg;  // the exchange slots' offset in a group's region
};

// Lay out `a` for a plant of S states and U controls; returns the block's
// dynamic shared memory in bytes, or -1 for a net the kernel refuses.  A
// block takes kResBlockWarps / kResGroupWarps groups, or fewer where they
// would not fit.
inline long plan_residual(const NetArgs& a, int S, int U, ResidualLayout& R) {
  MlpUnitsLayout& L = R.mlp;
  if (!residual_net(a) || plan_mlp_units(a, S, U, 1, L) < 0) return -1;
  R.xchg = L.group_floats;
  L.group_floats += 2 * 2 * kMmaRows * exchange_width(S);
  for (L.groups = kResBlockWarps / kResGroupWarps; L.groups >= 1; --L.groups) {
    const long bytes = 4L * (L.net.net_floats + static_cast<long>(L.groups) * L.group_floats);
    if (bytes <= kMaxSmem) return bytes;
  }
  return -1;
}

// K12's body over 16-rollout groups of two warps (see the note at the
// top): warp 0 runs the MLP, warp 1 the stage cost and the base step.
// Where Emit, the base-step warp also writes rollout k's terminal state to
// x_term [K, S] beside its cost.
template <class Plant, bool Emit>
__device__ __forceinline__ void residual_cost_rollout_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ x_term, int K, int ks, int H,
    const StepConsts& c, float max_cost, const NetArgs& net, const ResidualLayout& R) {
  constexpr int S = Plant::S, U = Plant::U, W = kResGroupWarps, X = exchange_width(S);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const MlpUnitsLayout& L = R.mlp;
  stage_mma_net(sm, net, L.net, S, U);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / W, w = warp - group * W;
  const int first = (blockIdx.x * L.groups + group) * kMmaRows;
  if (first >= K) return;  // the whole group: ragged K is masked
  // Lanes l and l+16 own rollout first + l; rows past K repeat rollout K-1.
  const int k = first + (lane & 15), kc = k < K ? k : K - 1;
  float* gsm = sm + L.net.net_floats + group * L.group_floats;
  const bool mlp_warp = w == 0;
  // Both warps of the group: each lane its rollout's session row (ks
  // rollouts a session), the base's constants with the cost's.
  float p[Plant::kN];
  load_params<Plant>(pvec + static_cast<size_t>(kc / ks) * Plant::kN, p);
  const typename Plant::Recips rc = Plant::recips(p);
  Rollout<Plant> r;
  r.start(s0 + static_cast<size_t>(kc) * S, p);
  const float* q = Q + static_cast<size_t>(kc) * H * U;
  for (int h = 0; h < H; ++h) {
    float u[U], a[S], xb[S];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
#pragma unroll
    for (int i = 0; i < S; ++i) a[i] = xb[i] = r.x[i];
    if (mlp_warp) {  // absolute form: a = mlp([x, u]), four unit tiles at a time
      if constexpr (kInlineMlp<Plant>) {
        mlp_units_step<S, U, 4>(sm, gsm, gsm + L.io, net, L, group, 0, h & 1, a, u);
      } else {
        mlp_units_step_call<S, U, 4>(sm, gsm, gsm + L.io, net, L, group, 0, h & 1, a, u);
      }
    } else {
      short_step<Plant>(xb, u, r.prev, r.acc, p, rc, c, max_cost);
    }
    // Exchange a and the base's x through step h's slots.
    float* slots = gsm + R.xchg + (h & 1) * 2 * kMmaRows * X + (lane & 15) * X;
    float* mine = slots + w * kMmaRows * X;
    const float* theirs = slots + (1 - w) * kMmaRows * X;
    if (lane < 16) {
#pragma unroll
      for (int i = 0; i < S; ++i) mine[i] = mlp_warp ? a[i] : xb[i];
    }
    group_sync(group, W);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (mlp_warp) {
        xb[i] = theirs[i];
      } else {
        a[i] = theirs[i];
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) r.x[i] = xb[i] + a[i];
  }
  if (!mlp_warp && lane < 16 && k < K) {
    cost[k] = r.finish(p, H);
    if constexpr (Emit) {
#pragma unroll
      for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(k) * S + i] = r.x[i];
    }
  }
}

// K12.  The registers are held to 128, so that four blocks (16 warps) fit
// an SM.
template <class Plant>
__global__ void __launch_bounds__(32 * kResBlockWarps, 4)
residual_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                             const float* __restrict__ pvec, float* __restrict__ cost, int K,
                             int ks, int H, StepConsts c, float max_cost, NetArgs net,
                             ResidualLayout R) {
  residual_cost_rollout_body<Plant, false>(s0, Q, pvec, cost, nullptr, K, ks, H, c, max_cost,
                                           net, R);
}

// K12's emit_terminal form (pallas_neural.py:367): its costs and the
// terminal states x_term [K, S]; one session or the session-row form.
// Held to K12's 128 registers.
template <class Plant>
__global__ void __launch_bounds__(32 * kResBlockWarps, 4)
residual_cost_rollout_emit_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                  const float* __restrict__ pvec, float* __restrict__ cost,
                                  int K, int ks, int H, StepConsts c, float max_cost,
                                  NetArgs net, ResidualLayout R, float* __restrict__ x_term) {
  residual_cost_rollout_body<Plant, true>(s0, Q, pvec, cost, x_term, K, ks, H, c, max_cost, net,
                                          R);
}

// K9's body; its value_spec form (kValue) adds V of the net of *v at x_H
// (mlp_mma.cuh value_mma_tail), the sessions' one V.
template <class Plant, bool kValue>
__device__ __forceinline__ void residual_grad_cost_rollout_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ dQ, float* __restrict__ xhist, int K, int ks,
    int H, const StepConsts& c, float max_cost, float ct, const NetArgs& net,
    const MmaLayout& L, const ValueArgs* v) {
  constexpr int S = Plant::S, U = Plant::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_mma_net(sm, net, L, S, U);
  if constexpr (kValue) stage_value_net(value_region(sm, L), *v);
  __syncthreads();
  const WarpRows rows(K);
  if (rows.first >= K) return;  // the whole warp past K
  const int k = rows.k;
  // The lane's rollout's session row: the base's constants with the cost's.
  float p[Plant::kN];
  load_params<Plant>(pvec + static_cast<size_t>(rows.kc / ks) * Plant::kN, p);
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
    if constexpr (kInlineMlp<Plant>) {
      mlp_mma_step<S, U>(sm, net, L, r.x, u, a);  // absolute form: a = mlp([x, u])
    } else {
      mlp_mma_step_call<S, U>(sm, net, L, r.x, u, a);
    }
    integrate<Plant>(r.x, u, p, c);
#pragma unroll
    for (int i = 0; i < S; ++i) r.x[i] = r.x[i] + a[i];
#pragma unroll
    for (int j = 0; j < U; ++j) r.prev[j] = u[j];
  }
  float vgx[S];  // ct * dV/dx_H (the value_spec form)
  if constexpr (kValue) {
    const float value = value_mma_tail<S>(sm, L, *v, r.x, ct, vgx);
    if (rows.writes) {
      cost[k] = (r.acc + (Plant::terminal_cost(r.x, p) + value)) / static_cast<float>(H + 1);
    }
  } else {
    if (rows.writes) cost[k] = r.finish(p, H);
  }

  // Backward sweep.
  float lam[S], gnext[U];
  Plant::terminal_cost_grad(r.x, p, ct, lam);
  if constexpr (kValue) {
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] += vgx[i];
  }
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
    if constexpr (kInlineMlp<Plant>) {
      mlp_mma_vjp<S, U>(sm, net, L, x, u, lam, dx_res, du_res);  // lam unchanged
    } else {
      mlp_mma_vjp_call<S, U>(sm, net, L, x, u, lam, dx_res, du_res);
    }
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

template <class Plant>
__global__ void __launch_bounds__(kMmaThreads, 1)
residual_grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                  const float* __restrict__ pvec, float* __restrict__ cost,
                                  float* __restrict__ dQ, float* __restrict__ xhist, int K,
                                  int ks, int H, StepConsts c, float max_cost, float ct,
                                  NetArgs net, MmaLayout L) {
  residual_grad_cost_rollout_body<Plant, false>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, c,
                                                max_cost, ct, net, L, nullptr);
}

// K9's value_spec form (pallas_grad.py:119-141, :191-206, the
// build_residual_grad_cost_rollout_kernel twin): one session or its
// session-row form, its own entry so that K9 keeps its code.
template <class Plant>
__global__ void __launch_bounds__(kMmaThreads, 1)
residual_grad_cost_rollout_value_kernel(const float* __restrict__ s0,
                                        const float* __restrict__ Q,
                                        const float* __restrict__ pvec, float* __restrict__ cost,
                                        float* __restrict__ dQ, float* __restrict__ xhist, int K,
                                        int ks, int H, StepConsts c, float max_cost, float ct,
                                        NetArgs net, MmaLayout L, ValueArgs v) {
  residual_grad_cost_rollout_body<Plant, true>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, c,
                                               max_cost, ct, net, L, &v);
}

// The dynamic shared memory each instance's attribute allows so far
// (allow_smem), a table a base plant: K12's, its emit_terminal form's, K9's
// and its value_spec form's.
struct ResidualAllowed {
  long k12 = 0, k12_emit = 0, k9 = 0, k9_value = 0;
};
template <class Plant>
ResidualAllowed& residual_allowed() {
  static ResidualAllowed allowed;
  return allowed;
}

// Allow K12's (or its emit form's) shared memory and launch `kernel` with
// `extra` arguments after the layout.
template <class Kernel, class... Extra>
int launch_k12(Kernel kernel, long& allowed, long bytes, const ResidualLayout& R,
               const void* s0, const void* Q, const void* pvec, void* cost, int K, int ks, int H,
               const StepConsts& c, float max_cost, const NetArgs& net, void* stream,
               Extra... extra) {
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = R.mlp.groups * kMmaRows;
  kernel<<<(K + per_block - 1) / per_block, 32 * kResGroupWarps * R.mlp.groups, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(Q),
      static_cast<const float*>(pvec), static_cast<float*>(cost), K, ks, H, c, max_cost, net, R,
      extra...);
  return static_cast<int>(cudaGetLastError());
}

// K12, or its emit_terminal form where x_term is not null, over the base
// plant `Plant`, laid out by plan_residual over its S and U.
template <class Plant>
int launch_residual_cost(long bytes, const ResidualLayout& R, const void* s0, const void* Q,
                         const void* pvec, void* cost, void* x_term, int K, int ks, int H,
                         const StepConsts& c, float max_cost, const NetArgs& net, void* stream) {
  ResidualAllowed& allowed = residual_allowed<Plant>();
  if (x_term != nullptr) {
    return launch_k12(residual_cost_rollout_emit_kernel<Plant>, allowed.k12_emit, bytes, R, s0, Q,
                      pvec, cost, K, ks, H, c, max_cost, net, stream,
                      static_cast<float*>(x_term));
  }
  return launch_k12(residual_cost_rollout_kernel<Plant>, allowed.k12, bytes, R, s0, Q, pvec, cost,
                    K, ks, H, c, max_cost, net, stream);
}

// Blocks of K12 (or its emit_terminal form) over `Plant` that one SM holds
// for `net` (0 for a refused net).
template <class Plant>
int residual_blocks_per_sm(bool emit, const NetArgs& net) {
  ResidualLayout R;
  const long bytes = plan_residual(net, Plant::S, Plant::U, R);
  ResidualAllowed& allowed = residual_allowed<Plant>();
  int blocks = 0;
  auto occupancy = [&](auto kernel, long& kernel_allowed) {
    return allow_smem(kernel, bytes, kernel_allowed) == cudaSuccess &&
           cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, kernel, 32 * kResGroupWarps * R.mlp.groups, bytes) == cudaSuccess;
  };
  if (bytes < 0) return 0;
  const bool ok = emit ? occupancy(residual_cost_rollout_emit_kernel<Plant>, allowed.k12_emit)
                       : occupancy(residual_cost_rollout_kernel<Plant>, allowed.k12);
  return ok ? blocks : 0;
}

// K9, or its value_spec form where v is not null, over the base plant
// `Plant`.
template <class Plant>
int launch_residual_grad(const void* s0, const void* Q, const void* pvec, void* cost, void* dQ,
                         void* xhist, int K, int ks, int H, const StepConsts& c, float max_cost,
                         float ct, const NetArgs& net, const ValueArgs* v, void* stream) {
  ResidualAllowed& allowed = residual_allowed<Plant>();
  if (v != nullptr) {
    return launch_mma_value(
        residual_grad_cost_rollout_value_kernel<Plant>, allowed.k9_value, net, *v, Plant::S,
        Plant::U, K, 1, stream, static_cast<const float*>(s0), static_cast<const float*>(Q),
        static_cast<const float*>(pvec), static_cast<float*>(cost), static_cast<float*>(dQ),
        static_cast<float*>(xhist), K, ks, H, c, max_cost, ct);
  }
  return launch_mma(residual_grad_cost_rollout_kernel<Plant>, allowed.k9, net, Plant::S,
                    Plant::U, K, stream, static_cast<const float*>(s0),
                    static_cast<const float*>(Q), static_cast<const float*>(pvec),
                    static_cast<float*>(cost), static_cast<float*>(dQ),
                    static_cast<float*>(xhist), K, ks, H, c, max_cost, ct);
}

// Blocks of K9 over `Plant` that one SM holds for `net`, and the block's
// dynamic shared memory into bytes (-1 and 0 blocks for a refused net).
template <class Plant>
int residual_grad_layout(const NetArgs& net, long& bytes) {
  MmaLayout L;
  bytes = residual_net(net) ? plan_mma(net, Plant::S, Plant::U, L) : -1;
  return bytes < 0 ? 0
                   : mma_blocks_per_sm(residual_grad_cost_rollout_kernel<Plant>,
                                       residual_allowed<Plant>().k9, net, Plant::S, Plant::U);
}

// The same for K9's value_spec form under the value net of v.
template <class Plant>
int residual_grad_value_layout(const NetArgs& net, const ValueArgs& v, long& bytes) {
  MmaLayout L;
  bytes = residual_net(net) ? plan_mma_value(net, v, Plant::S, Plant::U, L) : -1;
  return bytes < 0 ? 0
                   : mma_value_blocks_per_sm(residual_grad_cost_rollout_value_kernel<Plant>,
                                             residual_allowed<Plant>().k9_value, net, v, Plant::S,
                                             Plant::U);
}

// The instances over the pendulum, acrobot, point-mass, quadrotor, car and
// arm bases (rollout_core.cuh with_slice_plant), each as its cartpole
// counterpart above (cudaErrorInvalidValue, or 0 blocks, for another plant
// id): K12 and its emit_terminal form (residual_cost_plants.cu).
int launch_residual_cost_slice(int plant, long bytes, const ResidualLayout& R, const void* s0,
                               const void* Q, const void* pvec, void* cost, void* x_term, int K,
                               int ks, int H, const StepConsts& c, float max_cost,
                               const NetArgs& net, void* stream);
int residual_slice_blocks_per_sm(int plant, bool emit, const NetArgs& net);

// K9 and its value_spec form over the bases of ids Ids, and their layouts:
// the body of each of K9's plant groups.
template <int... Ids>
int launch_residual_grad_in(int plant, const void* s0, const void* Q, const void* pvec,
                            void* cost, void* dQ, void* xhist, int K, int ks, int H,
                            const StepConsts& c, float max_cost, float ct, const NetArgs& net,
                            const ValueArgs* v, void* stream) {
  return with_plant_in<Ids...>(plant, [&](auto plant_tag) {
    return launch_residual_grad<decltype(plant_tag)>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, c,
                                                     max_cost, ct, net, v, stream);
  });
}
template <int... Ids>
int residual_grad_layout_in(int plant, const NetArgs& net, const ValueArgs* v, long& bytes) {
  int blocks = 0;
  with_plant_in<Ids...>(plant, [&](auto plant_tag) {
    using Plant = decltype(plant_tag);
    blocks = v ? residual_grad_value_layout<Plant>(net, *v, bytes)
               : residual_grad_layout<Plant>(net, bytes);
    return 0;
  });
  return blocks;
}

// K9's plant groups, each compiled in a source of its own
// (residual_grad_plants_<group>.cu): the bases grouped by their residual
// MLP's widths (S, U), so that a source compiles each width's outlined MLP
// once (kInlineMlp) and no source's build grows.  residual_grad_group
// gives a plant id's group (-1: none).
inline int residual_grad_group(int plant) {
  switch (plant) {
    case kPlantPendulum: case kPlantPendulumFast: case kPlantQuadrotor2D:
    case kPlantQuadrotor2DFast:
      return 0;  // (2, 1) and (6, 2)
    case kPlantAcrobot: case kPlantAcrobotFast:
      return 1;  // (4, 1)
    case kPlantPointmass: case kPlantPointmassObstacles: case kPlantCar: case kPlantCarFast:
      return 2;  // (4, 2)
    case kPlantCarObstacles: case kPlantCarObstaclesFast: case kPlantArm2: case kPlantArm2Fast:
      return 3;  // (4, 2)
    case kPlantQuadrotor3D: case kPlantQuadrotor3DFast:
      return 4;  // (12, 4)
    default:
      return -1;
  }
}
template <int Group>
int launch_residual_grad_group(int plant, const void* s0, const void* Q, const void* pvec,
                               void* cost, void* dQ, void* xhist, int K, int ks, int H,
                               const StepConsts& c, float max_cost, float ct, const NetArgs& net,
                               const ValueArgs* v, void* stream);
template <int Group>
int residual_grad_group_layout(int plant, const NetArgs& net, const ValueArgs* v, long& bytes);
template <> int launch_residual_grad_group<0>(int, const void*, const void*, const void*, void*,
                                              void*, void*, int, int, int, const StepConsts&,
                                              float, float, const NetArgs&, const ValueArgs*,
                                              void*);
template <> int launch_residual_grad_group<1>(int, const void*, const void*, const void*, void*,
                                              void*, void*, int, int, int, const StepConsts&,
                                              float, float, const NetArgs&, const ValueArgs*,
                                              void*);
template <> int launch_residual_grad_group<2>(int, const void*, const void*, const void*, void*,
                                              void*, void*, int, int, int, const StepConsts&,
                                              float, float, const NetArgs&, const ValueArgs*,
                                              void*);
template <> int launch_residual_grad_group<3>(int, const void*, const void*, const void*, void*,
                                              void*, void*, int, int, int, const StepConsts&,
                                              float, float, const NetArgs&, const ValueArgs*,
                                              void*);
template <> int launch_residual_grad_group<4>(int, const void*, const void*, const void*, void*,
                                              void*, void*, int, int, int, const StepConsts&,
                                              float, float, const NetArgs&, const ValueArgs*,
                                              void*);
template <> int residual_grad_group_layout<0>(int, const NetArgs&, const ValueArgs*, long&);
template <> int residual_grad_group_layout<1>(int, const NetArgs&, const ValueArgs*, long&);
template <> int residual_grad_group_layout<2>(int, const NetArgs&, const ValueArgs*, long&);
template <> int residual_grad_group_layout<3>(int, const NetArgs&, const ValueArgs*, long&);
template <> int residual_grad_group_layout<4>(int, const NetArgs&, const ValueArgs*, long&);

// f(std::integral_constant<int, G>{}) for the group G of `plant`;
// cudaErrorInvalidValue where it has none.
template <class F>
int with_residual_grad_group(int plant, F&& f) {
  switch (residual_grad_group(plant)) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ctt
