// K11 and K13: rollout + trajectory cost over K control sequences under a
// learned network: an MLP (K11) or stacked GRU/LSTM cells from the live
// hidden (K13).  Each serves one session (ks = K) or, in its session-row
// form, B sessions of ks rollouts in one launch: rollout k reads row k / ks
// of pvec (and, K13, of each cell's hidden), so a 16-rollout group may
// straddle two sessions, each lane loading its own rollout's row
// (ops/neural_rollout.py *_cols, the batched-mpc fleet's).
//
// K11's member-block (n_members, pallas_neural.py:173) form serves the PETS
// ensemble (ops/neural_rollout.py neural_cost_rollout_ens): a stacked MLP
// of E members, rollout k under member k / (K/E) for the whole horizon.
// The Pallas runner fetched member tile // tiles_per_member's weights per
// grid tile (_make_runner, pallas_neural.py:290-307); here the grid is
// (blocks a member, E), each block stages its member's weights
// (stage_mma_net's member: each leaf's stride is its size, from the net's
// dims) and its groups take rows of that member alone, so a 16-rollout
// mma tile never straddles two members.  A ragged K/E is masked as a
// ragged K is, at the member's last rollout.  Its own entry
// (neural_cost_rollout_ens_kernel) over K11's body keeps the single-net
// kernel's code as it was; mlp-32-32, the ensemble's members, takes one
// warp a group (mlp_units.cuh's plan: a warp a four unit tiles).
//
// Their emit_terminal forms (pallas_neural.py:174, :210, :253-255; :466,
// :587-594) serve a learned value terminal (costs/value_terminal.py): the
// same costs and each rollout's state after step H written to x_term
// [K, S], row k, by the lanes that write cost[k] (warp 0's lanes l < 16),
// rows past K (K/E a member) writing nothing.  Each is its own entry over
// the kernel's body (neural_cost_rollout_emit_kernel,
// neural_cost_rollout_ens_emit_kernel, recurrent_cost_rollout_emit_kernel:
// the body's Emit instance), so the unvalued kernels' code stays as it
// was; the session-row form's entry is the same with ks < K, as the JAX
// runner composes emit_terminal with n_slot and n_members (_make_runner,
// pallas_neural.py:261).
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_neural_cost_rollout_kernel (K11) and
// build_recurrent_cost_rollout_kernel (K13), the kernels behind
// kernel_families/neural.py:build_cost.  Python wrappers and plain
// versions: ops/neural_rollout.py; K11's layers: mlp_units.cuh; K13's
// cells: rnn_mma.cuh.
//
// cost[k] = (sum_h stage(x_h, Q[k,h], Q[k,h-1]) + terminal(x_H)) / (H+1),
// Q[k,-1] = u_prev; the stage cost accrues before the step.  The packed
// parameters are the cost's alone (plants.cuh CartpoleCost): the dynamics
// are the net, staged from its tensors at every launch.
//
// What bounds them on an H100: the network's multiply-adds.  At the main
// path's K=16384, H=50, mlp-64-64 is 9,344 FLOP per rollout-step (7.7
// GFLOP a call, 0.11 ms at the 67 TFLOP/s FP32 peak); the bytes (Q in,
// cost out, the weights once per block) are < 4 MB.  Both run their
// products on the tensor cores, 3xTF32 mma.sync over 16-rollout groups of
// up to four warps that split each layer by unit (one thread a rollout
// gave the card 512 warps at K=16384, each FMA's operand from shared
// memory):
// - K11 (mlp_units.cuh): mlp-64-64 is 80 m16n8k8 tiles a group-step, 240
//   mma in 3xTF32, 31 GFLOP a call (0.06 ms at the 495 TFLOP/s TF32
//   rate), one named barrier a hidden layer; groups of two warps, 2,048
//   warps at K=16384 in one wave of one 16-warp block an SM.  On an H100
//   80GB HBM3 at 700 W (PERF.md) it takes about 0.35 ms there, as at
//   K=2048: each group's serial chain a step sets it.
// - K13 (rnn_mma.cuh): GRU-32-32 is 160 tiles a group-step, 480 mma, 50
//   GFLOP a call (0.10 ms), groups of four warps.
#include "mlp_units.cuh"
#include "neural_core.cuh"
#include "rnn_mma.cuh"

namespace ctt {

// K11's body.  The member-block form (kMembers) serves member blockIdx.y of
// a stacked ensemble: the block stages that member's weights and its groups
// take the member's ks rollouts [m ks, (m+1) ks), blockIdx.x counting blocks
// within the member, rows past the member's last repeating it; pvec is one
// row.  Otherwise ks rollouts a session, as above.  Where Emit, rollout k's
// terminal state is written to x_term [K, S] beside its cost.
template <class Cost, bool kMembers, bool Emit>
__device__ __forceinline__ void neural_cost_rollout_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ x_term, int K, int ks, int H, float max_cost,
    const NetArgs& net, const MlpUnitsLayout& L) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int member = kMembers ? static_cast<int>(blockIdx.y) : 0;
  stage_mma_net(sm, net, L.net, S, U, member);
  __syncthreads();
  const int begin = kMembers ? member * ks : 0, end = kMembers ? begin + ks : K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / L.warps, w = warp - group * L.warps;
  const int first = begin + (blockIdx.x * L.groups + group) * kMmaRows;
  if (first >= end) return;  // the whole group: ragged K (K/E) is masked
  // Lanes l and l+16 own rollout first + l; rows past the end repeat the
  // last rollout (K-1, or the member's last).
  const int k = first + (lane & 15), kc = k < end ? k : end - 1;
  float* gsm = sm + L.net.net_floats + group * L.group_floats;
  float* io = gsm + L.io + w * kMmaRows * 8;
  // Each lane its rollout's session row (ks rollouts a session); one row
  // for the member-block form.
  const float* row = kMembers ? pvec : pvec + static_cast<size_t>(kc / ks) * Cost::kN;
  float c[Cost::kN];
#pragma unroll
  for (int i = 0; i < Cost::kN; ++i) c[i] = __ldg(row + i);
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(kc) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = c[Cost::kUPrev + j];
  const float* q = Q + static_cast<size_t>(kc) * H * U;
  for (int h = 0; h < H; ++h) {
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    if (w == 0) acc = acc + Cost::stage_cost(x, u, prev, c, max_cost);  // warp 0's cost
    mlp_units_step<S, U>(sm, gsm, io, net, L, group, w, h & 1, x, u);
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  if (w == 0 && lane < 16 && k < end) {
    cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);
    if constexpr (Emit) {
#pragma unroll
      for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(k) * S + i] = x[i];
    }
  }
}

template <class Cost>
__global__ void __launch_bounds__(kRnnThreads)
neural_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                           const float* __restrict__ pvec, float* __restrict__ cost, int K,
                           int ks, int H, float max_cost, NetArgs net, MlpUnitsLayout L) {
  neural_cost_rollout_body<Cost, false, false>(s0, Q, pvec, cost, nullptr, K, ks, H, max_cost,
                                               net, L);
}

// The member-block (n_members) form: ks = K / E rollouts a member.
template <class Cost>
__global__ void __launch_bounds__(kRnnThreads)
neural_cost_rollout_ens_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                               const float* __restrict__ pvec, float* __restrict__ cost, int K,
                               int ks, int H, float max_cost, NetArgs net, MlpUnitsLayout L) {
  neural_cost_rollout_body<Cost, true, false>(s0, Q, pvec, cost, nullptr, K, ks, H, max_cost,
                                              net, L);
}

// K11's emit_terminal form (pallas_neural.py:174): its costs and the
// terminal states x_term [K, S]; one session or the session-row form.
template <class Cost>
__global__ void __launch_bounds__(kRnnThreads)
neural_cost_rollout_emit_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                const float* __restrict__ pvec, float* __restrict__ cost, int K,
                                int ks, int H, float max_cost, NetArgs net, MlpUnitsLayout L,
                                float* __restrict__ x_term) {
  neural_cost_rollout_body<Cost, false, true>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost,
                                              net, L);
}

// The member-block form's emit_terminal form.
template <class Cost>
__global__ void __launch_bounds__(kRnnThreads)
neural_cost_rollout_ens_emit_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                    const float* __restrict__ pvec, float* __restrict__ cost,
                                    int K, int ks, int H, float max_cost, NetArgs net,
                                    MlpUnitsLayout L, float* __restrict__ x_term) {
  neural_cost_rollout_body<Cost, true, true>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, net,
                                             L);
}

// K13's body; where Emit, rollout k's terminal state is written to x_term
// [K, S] beside its cost.
template <class Cost, int G, bool Emit>
__device__ __forceinline__ void recurrent_cost_rollout_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ x_term, int K, int ks, int H, float max_cost,
    const NetArgs& net, const RnnLayout& L) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_rnn_net<G>(sm, net, L, S);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / L.warps, w = warp - group * L.warps;
  const int first = (blockIdx.x * L.groups + group) * kMmaRows;
  if (first >= K) return;  // the whole group: ragged K is masked
  // Lanes l and l+16 own rollout first + l; rows past K repeat rollout K-1.
  const int k = first + (lane & 15), kc = k < K ? k : K - 1;
  float* gsm = sm + L.net_floats + group * L.group_floats;
  float* io = gsm + L.io + w * kMmaRows * 8;
  rnn_mma_start<G>(gsm, net, L, w, first, K, ks);
  group_sync(group, L.warps);
  // Each lane its rollout's session row (ks rollouts a session).
  const float* row = pvec + static_cast<size_t>(kc / ks) * Cost::kN;
  float c[Cost::kN];
#pragma unroll
  for (int i = 0; i < Cost::kN; ++i) c[i] = __ldg(row + i);
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(kc) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = c[Cost::kUPrev + j];
  const float* q = Q + static_cast<size_t>(kc) * H * U;
  for (int h = 0; h < H; ++h) {
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    acc = acc + Cost::stage_cost(x, u, prev, c, max_cost);
    rnn_mma_step<G, S, U>(sm, gsm, io, net, L, group, w, h & 1, x, u);
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  if (w == 0 && lane < 16 && k < K) {
    cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);
    if constexpr (Emit) {
#pragma unroll
      for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(k) * S + i] = x[i];
    }
  }
}

template <class Cost, int G>
__global__ void __launch_bounds__(kRnnThreads)
recurrent_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                              const float* __restrict__ pvec, float* __restrict__ cost, int K,
                              int ks, int H, float max_cost, NetArgs net, RnnLayout L) {
  recurrent_cost_rollout_body<Cost, G, false>(s0, Q, pvec, cost, nullptr, K, ks, H, max_cost,
                                              net, L);
}

// K13's emit_terminal form (pallas_neural.py:466): its costs and the
// terminal states x_term [K, S].
template <class Cost, int G>
__global__ void __launch_bounds__(kRnnThreads)
recurrent_cost_rollout_emit_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                   const float* __restrict__ pvec, float* __restrict__ cost,
                                   int K, int ks, int H, float max_cost, NetArgs net, RnnLayout L,
                                   float* __restrict__ x_term) {
  recurrent_cost_rollout_body<Cost, G, true>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, net,
                                             L);
}

// Plan K13's layout for `net`, allow the shared memory and launch `kernel`
// (with `extra` arguments after the layout: an emit form's x_term).
template <class Kernel, class... Extra>
int launch_rnn_kernel(Kernel kernel, long& allowed, const NetArgs& net, int S, int U,
                      const void* s0, const void* Q, const void* pvec, void* cost, int K, int ks,
                      int H, float max_cost, void* stream, Extra... extra) {
  RnnLayout L;
  const long bytes = plan_rnn(net, S, U, L);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = L.groups * kMmaRows;
  const dim3 grid((K + per_block - 1) / per_block);
  kernel<<<grid, 32 * L.warps * L.groups, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(Q),
      static_cast<const float*>(pvec), static_cast<float*>(cost), K, ks, H, max_cost, net, L,
      extra...);
  return static_cast<int>(cudaGetLastError());
}

// Plan K11's layout for `net` with `warps` warps a group (0: the plan's),
// allow the shared memory and launch `kernel` on `stream` over `members`
// blocks of K / members rollouts (blockIdx.y the block's member; one for
// the single-net kernel), with `extra` arguments after the layout.
template <class Kernel, class... Extra>
int launch_mlp_units(Kernel kernel, long& allowed, const NetArgs& net, int S, int U, int warps,
                     const void* s0, const void* Q, const void* pvec, void* cost, int K, int ks,
                     int H, float max_cost, int members, void* stream, Extra... extra) {
  MlpUnitsLayout L;
  const long bytes = plan_mlp_units(net, S, U, warps, L);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = L.groups * kMmaRows;
  const dim3 grid((K / members + per_block - 1) / per_block, members);
  kernel<<<grid, 32 * L.warps * L.groups, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(Q),
      static_cast<const float*>(pvec), static_cast<float*>(cost), K, ks, H, max_cost, net, L,
      extra...);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `kernel` (K13) that one SM holds for `net` (0 for a refused net).
template <class Kernel>
int rnn_blocks_per_sm(Kernel kernel, long& allowed, const NetArgs& net, int S, int U) {
  RnnLayout L;
  const long bytes = plan_rnn(net, S, U, L);
  int blocks = 0;
  if (bytes < 0 || allow_smem(kernel, bytes, allowed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * L.warps * L.groups,
                                                    bytes) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

}  // namespace ctt

extern "C" long ctt_net_smem_bytes(const ctt::NetArgs* net, int S, int U) {
  if (net->kind == ctt::kNetGRU || net->kind == ctt::kNetLSTM) {
    ctt::RnnLayout R;
    return ctt::plan_rnn(*net, S, U, R);
  }
  ctt::MlpUnitsLayout L;
  return ctt::plan_mlp_units(*net, S, U, 0, L);
}

namespace {
// K11's and its member-block form's dynamic shared memory allowed so far,
// and their emit_terminal forms'.
long allowed_mlp = 0, allowed_mlp_ens = 0, allowed_mlp_emit = 0, allowed_mlp_ens_emit = 0;
}  // namespace

// K11's layout for `net` with `warps` warps a group (0: the plan's own):
// the block's dynamic shared memory in bytes (-1 for a refused net), and
// in *group_warps and *groups the warps a group and the groups a block.
extern "C" long ctt_neural_plan(const ctt::NetArgs* net, int S, int U, int warps,
                                int* group_warps, int* groups) {
  ctt::MlpUnitsLayout L;
  const long bytes = ctt::plan_mlp_units(*net, S, U, warps, L);
  *group_warps = bytes < 0 ? 0 : L.warps;
  *groups = bytes < 0 ? 0 : L.groups;
  return bytes;
}

// Launches K11 (an MLP net) on `stream` over K rollouts, sessions of ks
// (pvec holds K / ks rows, rollout k reading row k / ks: ks = K for one
// session, the session-row form for a fleet), with `warps` warps a
// 16-rollout group (1, 2 or 4; 0 for the plan's own), or, with x_term not
// null, its emit_terminal form, which also writes the terminal states
// [K, S] there (one session or sessions of ks alike); returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown plant, another `warps`, a ks that does not divide K or a net the
// kernel refuses.
extern "C" int ctt_neural_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                       void* cost, void* x_term, int K, int ks, int H,
                                       float max_cost, int warps, const ctt::NetArgs* net,
                                       void* stream) {
  using Cost = ctt::CartpoleCost;
  if (plant != ctt::kPlantCartpole || net->kind != ctt::kNetMLP || ks < 1 || K % ks != 0 ||
      (warps != 0 && warps != 1 && warps != 2 && warps != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_term != nullptr) {
    return ctt::launch_mlp_units(ctt::neural_cost_rollout_emit_kernel<Cost>, allowed_mlp_emit,
                                 *net, Cost::S, Cost::U, warps, s0, Q, pvec, cost, K, ks, H,
                                 max_cost, 1, stream, static_cast<float*>(x_term));
  }
  return ctt::launch_mlp_units(ctt::neural_cost_rollout_kernel<Cost>, allowed_mlp, *net, Cost::S,
                               Cost::U, warps, s0, Q, pvec, cost, K, ks, H, max_cost, 1, stream);
}

// Launches K11's member-block (n_members) form on `stream` over K rollouts
// under the stacked ensemble `net` (member 0's pointers; every tensor with
// a leading member axis), ks = K / E rollouts a member: rollout k under
// member k / ks, pvec one row, the plan's warps a group; with x_term not
// null, its emit_terminal form (the terminal states [K, S] there); returns
// as above, or cudaErrorInvalidValue for a ks that does not divide K.
extern "C" int ctt_neural_cost_rollout_ens(int plant, const void* s0, const void* Q,
                                           const void* pvec, void* cost, void* x_term, int K,
                                           int ks, int H, float max_cost,
                                           const ctt::NetArgs* net, void* stream) {
  using Cost = ctt::CartpoleCost;
  if (plant != ctt::kPlantCartpole || net->kind != ctt::kNetMLP || ks < 1 || K % ks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_term != nullptr) {
    return ctt::launch_mlp_units(ctt::neural_cost_rollout_ens_emit_kernel<Cost>,
                                 allowed_mlp_ens_emit, *net, Cost::S, Cost::U, 0, s0, Q, pvec,
                                 cost, K, ks, H, max_cost, K / ks, stream,
                                 static_cast<float*>(x_term));
  }
  return ctt::launch_mlp_units(ctt::neural_cost_rollout_ens_kernel<Cost>, allowed_mlp_ens, *net,
                               Cost::S, Cost::U, 0, s0, Q, pvec, cost, K, ks, H, max_cost,
                               K / ks, stream);
}

namespace {
// Blocks of the K11 `kernel` that one SM holds for `net` with the plan's
// warps a group (0 for a refused net).
template <class Kernel>
int mlp_units_blocks_per_sm(Kernel kernel, long& allowed, const ctt::NetArgs& net) {
  using Cost = ctt::CartpoleCost;
  ctt::MlpUnitsLayout L;
  const long bytes = ctt::plan_mlp_units(net, Cost::S, Cost::U, 0, L);
  int blocks = 0;
  if (bytes < 0 || ctt::allow_smem(kernel, bytes, allowed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * L.warps * L.groups,
                                                    bytes) != cudaSuccess) {
    return 0;
  }
  return blocks;
}
}  // namespace

// Blocks of K11 that one SM holds for `net` with the plan's warps a group
// (0 for a refused net).
extern "C" int ctt_neural_blocks_per_sm(const ctt::NetArgs* net) {
  return mlp_units_blocks_per_sm(ctt::neural_cost_rollout_kernel<ctt::CartpoleCost>, allowed_mlp,
                                 *net);
}

// Blocks of K11's member-block form that one SM holds for one member's net
// of `net` (0 for a refused net).
extern "C" int ctt_neural_ens_blocks_per_sm(const ctt::NetArgs* net) {
  return mlp_units_blocks_per_sm(ctt::neural_cost_rollout_ens_kernel<ctt::CartpoleCost>,
                                 allowed_mlp_ens, *net);
}

namespace {
// K13's dynamic shared memory allowed so far, and its emit_terminal form's.
long allowed_gru = 0, allowed_lstm = 0, allowed_gru_emit = 0, allowed_lstm_emit = 0;

// Launch K13 with G gates a unit, or its emit_terminal form where x_term
// is not null.
template <int G>
int launch_k13(long& allowed, long& allowed_emit, const ctt::NetArgs& net, const void* s0,
               const void* Q, const void* pvec, void* cost, void* x_term, int K, int ks, int H,
               float max_cost, void* stream) {
  using Cost = ctt::CartpoleCost;
  if (x_term != nullptr) {
    return ctt::launch_rnn_kernel(ctt::recurrent_cost_rollout_emit_kernel<Cost, G>, allowed_emit,
                                  net, Cost::S, Cost::U, s0, Q, pvec, cost, K, ks, H, max_cost,
                                  stream, static_cast<float*>(x_term));
  }
  return ctt::launch_rnn_kernel(ctt::recurrent_cost_rollout_kernel<Cost, G>, allowed, net,
                                Cost::S, Cost::U, s0, Q, pvec, cost, K, ks, H, max_cost, stream);
}
}  // namespace

// Launches K13 (a GRU or LSTM net) on `stream` over K rollouts, sessions
// of ks as K11's: rollout k reads pvec's row k / ks and starts from row
// k / ks of each cell's hidden (net->hidden[l], [K / ks, Hd] for the GRU,
// [K / ks, 2 Hd] for the LSTM's [h, c]); with x_term not null, its
// emit_terminal form (the terminal states [K, S] there); returns as above.
extern "C" int ctt_recurrent_cost_rollout(int plant, const void* s0, const void* Q,
                                          const void* pvec, void* cost, void* x_term, int K,
                                          int ks, int H, float max_cost,
                                          const ctt::NetArgs* net, void* stream) {
  if (plant != ctt::kPlantCartpole || ks < 1 || K % ks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (net->kind) {
    case ctt::kNetGRU:
      return launch_k13<3>(allowed_gru, allowed_gru_emit, *net, s0, Q, pvec, cost, x_term, K, ks,
                           H, max_cost, stream);
    case ctt::kNetLSTM:
      return launch_k13<4>(allowed_lstm, allowed_lstm_emit, *net, s0, Q, pvec, cost, x_term, K,
                           ks, H, max_cost, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of K13 that one SM holds for `net` (0 for a refused net).
extern "C" int ctt_recurrent_blocks_per_sm(const ctt::NetArgs* net) {
  using Cost = ctt::CartpoleCost;
  switch (net->kind) {
    case ctt::kNetGRU:
      return ctt::rnn_blocks_per_sm(ctt::recurrent_cost_rollout_kernel<Cost, 3>, allowed_gru,
                                    *net, Cost::S, Cost::U);
    case ctt::kNetLSTM:
      return ctt::rnn_blocks_per_sm(ctt::recurrent_cost_rollout_kernel<Cost, 4>, allowed_lstm,
                                    *net, Cost::S, Cost::U);
    default:
      return 0;
  }
}
