// K8: rollout cost J under an MLP and its gradient dJ/dQ over K control
// sequences, in one forward-store / backward-sweep pass per rollout.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:
// build_neural_grad_cost_rollout_kernel (body _make_fwd_bwd_kernel, runner
// _make_grad_runner; the kernel behind kernel_families/neural.py:
// build_grad).  Python wrapper and plain version:
// ops/neural_grad_cost_rollout.py.  It is K7 (grad_cost_rollout.cu) with
// the MLP step on tensor cores (mlp_mma.cuh mlp_mma_step / mlp_mma_vjp,
// transcribed from ops/adjoints.py mlp_step_vjp) in place of the
// integrator; the cost's adjoints are the plants.cuh cost's (stage_cost,
// stage_cost_vjp, terminal_cost_grad).  The Pallas kernel transposed the
// step with jax.vjp at trace time.
//
// Every body is a template over the cost, as the Pallas builder takes the
// cost's SOA primitives (stage_cost_soa, terminal_cost_soa), so each of the
// ten costs is an instance of each entry: cartpole's in
// neural_grad_rollout.cu with the MLP's step and VJP inlined (kInlineNet),
// the other nine costs' in neural_grad_plants_<group>.cu, grouped by (S, U)
// as the forward network kernels' are (neural_core.cuh net_group), the step
// and VJP outlined calls (mlp_mma_step_call, mlp_mma_vjp_call) that a source
// compiles once for each width.  The 3-D quadrotor's 16 inputs and 12
// outputs take two lane tiles each way (mlp_mma.cuh io_tiles).
//
// K8 serves one session (ks = K) or, in its session-row form (the
// slot_keys form, pallas_grad.py:401), B sessions of ks rollouts in one
// launch, each lane reading the cost's row k / ks of pvec for its rollout
// k (lanes l and l+16 share a rollout): a 16-rollout warp straddles two
// sessions whenever ks is not a multiple of 16.  The weights are shared.
//
// Its member-block (n_members, pallas_grad.py:402) form serves the PETS
// ensemble (ops/neural_grad_cost_rollout.py neural_grad_cost_rollout_ens):
// a stacked net of E members, rollout k under member k / (K/E).  The Pallas
// runner fetched member tile // tiles_per_member's weights per grid tile
// (_make_grad_runner, pallas_grad.py:278-290); here the grid is (blocks a
// member, E), each block stages its member's weights (stage_mma_net's
// member, the leaf's size its stride) and its warps take rows of that
// member alone, so a warp's B fragments are one member's.  A ragged K/E is
// masked as a ragged K is, at the member's last rollout.  It is its own
// entry (neural_grad_cost_rollout_ens_kernel) over K8's body, so the
// single-net kernel's code is unchanged.
//
// The value_spec form (pallas_grad.py:119-141, :191-206) of both, and of
// the session-row form, adds a learned terminal value V (value_mlp.cuh):
//   cost = (sum_h stage + terminal + V(x_H)) / (H+1),
//   lam_H = ct * (d terminal / d x_H + dV / d x_H).
// Each block stages V's operands after the net's and the warps' regions;
// after the forward sweep lane l < 16 evaluates V and its VJP for its
// rollout in its column of a [units][128] activation array and lane l+16
// takes both by a shuffle, so the pair goes on with one lam.  V is shared
// by sessions and members (pallas_grad.py:158).  Its entries
// (neural_grad_cost_rollout_value_kernel, _ens_value_kernel) are the
// body's kValue instances, so K8 and K8-ens keep their code.
//
// Forward: store x_h, add the stage cost, step; cost[k] = (sum_h stage +
// terminal) / (H+1).  Backward, h = H-1 .. 0, with ct = 1/(H+1):
//   lam = ct * d terminal / d x_H
//   (dx, du) = the MLP step's VJP at the stored x_h (the step is re-run)
//   (gx, gu, gprev_h) = the stage cost's gradient at ct
//   dQ[k,h] = (du + gu) + gprev_{h+1}       gprev_H = 0
//   lam = dx + gx
// The states go to the wrapper-allocated scratch xhist [H, S, K], rollout
// index fastest, as in K7 (13.1 MB at K=16384, H=50, inside the 50 MB L2);
// lane l writes row l's and reads it back, and lane l+16 takes it by a
// shuffle.
//
// What bounds it on an H100, mlp-64-64 at K=16384, H=50.  In FP32, one
// forward plus the transposed layers with the costs are 15.9 GFLOP, 0.2375
// ms at the 67 TFLOP/s FP32 peak (chip_smoke.py's bound).  On tensor cores
// the kernel's own work is the forward, the backward's re-run (its last
// layer skipped) and the transposed layers, padded to 8 and at 3x for the
// split: 73 GFLOP of mma, 0.147 ms at 495 TFLOP/s, 0.160 ms with the
// scalar work (costs, biases, tanh, norms) at the FP32 rate (tc_bound_ms).
// The design (mlp_mma.cuh) takes the layers to the tensor cores in 3xTF32,
// keeps the activations in registers, and puts a warp on 16 rollouts:
// 1024 warps at K=16384, eight an SM, against the one-thread-per-rollout
// kernel's four, whose every FMA waited on a shared-memory operand.  What
// bounds it in practice is each warp's own chain of dependent mma,
// shared-memory loads and tanhf, with two warps a scheduler to hide it:
// its time is the same at K=2048 as at 16384 (PERF.md section 6).
#pragma once

#include "mlp_mma.cuh"

namespace ctt {

// K8's body.  The member-block form (kMembers) serves member blockIdx.y of
// a stacked ensemble: the block stages that member's weights and its warps
// take the member's ks rollouts [m ks, (m+1) ks), blockIdx.x counting
// blocks within the member, rows past the member's last repeating it; pvec
// is one row.  Otherwise ks rollouts a session, as above.  The value_spec
// form (kValue) adds V of the net of *v (shared by sessions and members)
// at x_H: value_mma_tail.
template <class Cost, bool kMembers, bool kValue = false>
__device__ __forceinline__ void neural_grad_cost_rollout_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ dQ, float* __restrict__ xhist, int K, int ks,
    int H, float max_cost, float ct, const NetArgs& net, const MmaLayout& L,
    const ValueArgs* v = nullptr) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int member = kMembers ? static_cast<int>(blockIdx.y) : 0;
  stage_mma_net(sm, net, L, S, U, member);
  if constexpr (kValue) stage_value_net(value_region(sm, L), *v);
  __syncthreads();
  const int end = kMembers ? (member + 1) * ks : K;
  const WarpRows rows = kMembers ? WarpRows(member * ks, end) : WarpRows(K);
  if (rows.first >= end) return;  // the whole warp past K (past its member's rows)
  const int k = rows.k;
  // The lane's rollout's session row (ks rollouts a session); one row for
  // the member-block form.
  const float* row = kMembers ? pvec : pvec + static_cast<size_t>(rows.kc / ks) * Cost::kN;
  float c[Cost::kN];
#pragma unroll
  for (int i = 0; i < Cost::kN; ++i) c[i] = __ldg(row + i);
  const float* q = Q + static_cast<size_t>(rows.kc) * H * U;
  float* dq = dQ + static_cast<size_t>(k) * H * U;

  // Forward sweep.
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(rows.kc) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = c[Cost::kUPrev + j];
  for (int h = 0; h < H; ++h) {
    if (rows.writes) {
#pragma unroll
      for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(h) * S + i) * K + k] = x[i];
    }
    float u[U], o[S];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    acc = acc + Cost::stage_cost(x, u, prev, c, max_cost);
    if constexpr (kInlineNet<Cost>) {
      mlp_mma_step<S, U>(sm, net, L, x, u, o);
    } else {
      mlp_mma_step_call<S, U>(sm, net, L, x, u, o);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = net.predict_delta ? x[i] + o[i] : o[i];
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  float vgx[S];  // ct * dV/dx_H (the value_spec form)
  if constexpr (kValue) {
    const float value = value_mma_tail<S>(sm, L, *v, x, ct, vgx);
    if (rows.writes) {
      cost[k] = (acc + (Cost::terminal_cost(x, c) + value)) / static_cast<float>(H + 1);
    }
  } else {
    if (rows.writes) cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);
  }

  // Backward sweep.
  float lam[S], gnext[U];
  Cost::terminal_cost_grad(x, c, ct, lam);
  if constexpr (kValue) {
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] += vgx[i];
  }
#pragma unroll
  for (int j = 0; j < U; ++j) gnext[j] = 0.0f;
  for (int h = H - 1; h >= 0; --h) {
    float xh[S], u[U];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      xh[i] = __shfl_sync(0xffffffffu, xhist[(static_cast<size_t>(h) * S + i) * K + rows.kc],
                          threadIdx.x & 15);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = __ldg(q + h * U + j);
      prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : c[Cost::kUPrev + j];
    }
    float dx[S], du[U], gx[S], gu[U], gp[U];
    if constexpr (kInlineNet<Cost>) {
      mlp_mma_vjp<S, U>(sm, net, L, xh, u, lam, dx, du);
    } else {
      mlp_mma_vjp_call<S, U>(sm, net, L, xh, u, lam, dx, du);
    }
    Cost::stage_cost_vjp(xh, u, prev, c, ct, gx, gu, gp);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (rows.writes) dq[h * U + j] = (du[j] + gu[j]) + gnext[j];
      gnext[j] = gp[j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = (net.predict_delta ? lam[i] + dx[i] : dx[i]) + gx[i];
  }
}

template <class Cost>
__global__ void __launch_bounds__(kMmaThreads, 1)
neural_grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                const float* __restrict__ pvec, float* __restrict__ cost,
                                float* __restrict__ dQ, float* __restrict__ xhist, int K, int ks,
                                int H, float max_cost, float ct, NetArgs net, MmaLayout L) {
  neural_grad_cost_rollout_body<Cost, false>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost,
                                             ct, net, L);
}

// The member-block (n_members) form: ks = K / E rollouts a member.
template <class Cost>
__global__ void __launch_bounds__(kMmaThreads, 1)
neural_grad_cost_rollout_ens_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                    const float* __restrict__ pvec, float* __restrict__ cost,
                                    float* __restrict__ dQ, float* __restrict__ xhist, int K,
                                    int ks, int H, float max_cost, float ct, NetArgs net,
                                    MmaLayout L) {
  neural_grad_cost_rollout_body<Cost, true>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost,
                                            ct, net, L);
}

// K8's value_spec form (pallas_grad.py:119-141, :191-206): the body's
// kValue instance, as its own entries so that the kernels above keep
// their code.  One session (ks = K) or its session-row form.
template <class Cost>
__global__ void __launch_bounds__(kMmaThreads, 1)
neural_grad_cost_rollout_value_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                      const float* __restrict__ pvec, float* __restrict__ cost,
                                      float* __restrict__ dQ, float* __restrict__ xhist, int K,
                                      int ks, int H, float max_cost, float ct, NetArgs net,
                                      MmaLayout L, ValueArgs v) {
  neural_grad_cost_rollout_body<Cost, false, true>(s0, Q, pvec, cost, dQ, xhist, K, ks, H,
                                                   max_cost, ct, net, L, &v);
}

// The value_spec form of the member-block form: every member under one V
// (pallas_grad.py:158).
template <class Cost>
__global__ void __launch_bounds__(kMmaThreads, 1)
neural_grad_cost_rollout_ens_value_kernel(const float* __restrict__ s0,
                                          const float* __restrict__ Q,
                                          const float* __restrict__ pvec,
                                          float* __restrict__ cost, float* __restrict__ dQ,
                                          float* __restrict__ xhist, int K, int ks, int H,
                                          float max_cost, float ct, NetArgs net, MmaLayout L,
                                          ValueArgs v) {
  neural_grad_cost_rollout_body<Cost, true, true>(s0, Q, pvec, cost, dQ, xhist, K, ks, H,
                                                  max_cost, ct, net, L, &v);
}

// ---- the launches, over any cost ---------------------------------------------

// One call of K8's C entries (neural_grad_rollout.cu), as the entry checked
// it: the launch of the instance over the cost of plant id `plant` that the
// form names (the member-block form where members, ks = K / E rollouts a
// member; its value_spec form where v is not null), or, where bytes is not
// null, no launch: the block's dynamic shared memory of that instance's
// layout into *bytes (-1 for a net either net refuses) and the blocks one
// SM holds of it returned (0 where refused).
struct GradCall {
  int plant, members;
  const void* s0;
  const void* Q;
  const void* pvec;
  void* cost;
  void* dQ;
  void* xhist;
  int K, ks, H;
  float max_cost, ct;
  const NetArgs* net;
  const ValueArgs* v;
  void* stream;
  long* bytes;
};

// The dynamic shared memory allowed so far to the instance `Tag` of a
// cost's K8 entries (one a kernel: allow_smem's `allowed`).
template <class Cost, int Tag>
long& neural_grad_allowed() {
  static long bytes = 0;
  return bytes;
}

// The call `c` over Cost's instances.
template <class Cost>
int neural_grad_call(const GradCall& c) {
  constexpr int S = Cost::S, U = Cost::U;
  const NetArgs& net = *c.net;
  if (c.bytes != nullptr) {
    MmaLayout L;
    if (c.v != nullptr) {
      *c.bytes = plan_mma_value(net, *c.v, S, U, L);
      return c.members ? mma_value_blocks_per_sm(neural_grad_cost_rollout_ens_value_kernel<Cost>,
                                                 neural_grad_allowed<Cost, 3>(), net, *c.v, S, U)
                       : mma_value_blocks_per_sm(neural_grad_cost_rollout_value_kernel<Cost>,
                                                 neural_grad_allowed<Cost, 2>(), net, *c.v, S, U);
    }
    *c.bytes = plan_mma(net, S, U, L);
    return c.members ? mma_blocks_per_sm(neural_grad_cost_rollout_ens_kernel<Cost>,
                                         neural_grad_allowed<Cost, 1>(), net, S, U)
                     : mma_blocks_per_sm(neural_grad_cost_rollout_kernel<Cost>,
                                         neural_grad_allowed<Cost, 0>(), net, S, U);
  }
  const float* s0 = static_cast<const float*>(c.s0);
  const float* Q = static_cast<const float*>(c.Q);
  const float* pvec = static_cast<const float*>(c.pvec);
  float* cost = static_cast<float*>(c.cost);
  float* dQ = static_cast<float*>(c.dQ);
  float* xhist = static_cast<float*>(c.xhist);
  // The grid: blocks over K rollouts, or over ks rollouts a member for each
  // of the K / ks members.
  const int rows = c.members ? c.ks : c.K, members = c.members ? c.K / c.ks : 1;
  if (c.v != nullptr) {
    return c.members
               ? launch_mma_value(neural_grad_cost_rollout_ens_value_kernel<Cost>,
                                  neural_grad_allowed<Cost, 3>(), net, *c.v, S, U, rows, members,
                                  c.stream, s0, Q, pvec, cost, dQ, xhist, c.K, c.ks, c.H,
                                  c.max_cost, c.ct)
               : launch_mma_value(neural_grad_cost_rollout_value_kernel<Cost>,
                                  neural_grad_allowed<Cost, 2>(), net, *c.v, S, U, rows, members,
                                  c.stream, s0, Q, pvec, cost, dQ, xhist, c.K, c.ks, c.H,
                                  c.max_cost, c.ct);
  }
  return c.members
             ? launch_mma_members(neural_grad_cost_rollout_ens_kernel<Cost>,
                                  neural_grad_allowed<Cost, 1>(), net, S, U, rows, members,
                                  c.stream, s0, Q, pvec, cost, dQ, xhist, c.K, c.ks, c.H,
                                  c.max_cost, c.ct)
             : launch_mma_members(neural_grad_cost_rollout_kernel<Cost>,
                                  neural_grad_allowed<Cost, 0>(), net, S, U, rows, members,
                                  c.stream, s0, Q, pvec, cost, dQ, xhist, c.K, c.ks, c.H,
                                  c.max_cost, c.ct);
}

// What a call over a plant that no instance serves returns: 0 blocks (and
// -1 bytes) for a layout query, else cudaErrorInvalidValue.
inline int neural_grad_refused(const GradCall& c) {
  if (c.bytes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *c.bytes = -1;
  return 0;
}

// The costs' groups (net_group), each compiled in a source of its own
// (neural_grad_plants_<group>.cu).
int neural_grad_plants_0(const GradCall& c);
int neural_grad_plants_1(const GradCall& c);
int neural_grad_plants_2(const GradCall& c);
int neural_grad_plants_3(const GradCall& c);
int neural_grad_plants_4(const GradCall& c);

// The call `c` over its cost's group; refused (neural_grad_refused) for a
// plant that is no cost of the nine, a fast plant's id among them.
inline int neural_grad_plants(const GradCall& c) {
  switch (net_group(c.plant)) {
    case 0: return neural_grad_plants_0(c);
    case 1: return neural_grad_plants_1(c);
    case 2: return neural_grad_plants_2(c);
    case 3: return neural_grad_plants_3(c);
    case 4: return neural_grad_plants_4(c);
    default: return neural_grad_refused(c);
  }
}

// neural_grad_call over the cost of c.plant among the ids Ids (a group's,
// neural_grad_plants_<group>.cu); refused for any other id.
template <int... Ids>
int neural_grad_call_in(const GradCall& c) {
  if (!((c.plant == Ids) || ...)) return neural_grad_refused(c);
  return with_cost_in<Ids...>(
      c.plant, [&](auto cost_tag) { return neural_grad_call<decltype(cost_tag)>(c); });
}

}  // namespace ctt
