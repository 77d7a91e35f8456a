// K1: rollout + trajectory cost over K control sequences.
//
// Replaces control_toolkit_tpu/ops/pallas_rollout.py:build_cost_rollout_kernel
// (the Pallas kernel behind kernel_families/ode.py:build_cost).  Python
// wrapper and plain version: ops/cost_rollout.py.
//
// cost[k] = (sum_h stage(x_h, Q[k,h], Q[k,h-1]) + terminal(x_H)) / (H+1)
// with Q[k,-1] = u_prev from the packed parameters.
//
// Over the fast plant (CartpoleFastPlant: the ":fast" predictors) each
// entry below is instantiated again: its polynomial trig in the step, the
// cost exact (short_step.cuh).  The pendulum, acrobot and point-mass plants
// (plants.cuh; with their fast plants) take the single-session kernel
// alone: short_step.cuh's stage cost and integrate (they have no
// derivs_short); the emit_terminal and session-row forms stay cartpole's
// (ops/kernels.py KERNEL_PLANTS).
//
// K1's emit_terminal form (one session, cost_rollout_emit_kernel, and the
// session-row form, cost_rollout_emit_rows_kernel) is the body's Emit
// instance: it also writes rollout k's x_H to row k of x_term [K, S].
//
// K1 serves one session (ks = K) or, in its session-row form (the
// slot_keys form, pallas_rollout.py:47), B sessions of ks rollouts in one
// launch, rollout k reading row k / ks of pvec: the session's dynamics
// constants, cost weights, attributes and previous control.  A block may
// straddle two sessions; each thread reads its own rollout's row.  The
// two are instantiations of one template (Rows): one session reads row 0
// at an address uniform over the grid, so its parameters need no
// per-thread registers (a per-thread row costs 6 more, 48 -> 54), and the
// single-session kernel stays as it was.  The arithmetic is the same, so
// the form equals the single-session kernel per session.
//
// What bounds it on an H100: the serial H-step rk4 chain each thread runs
// in FP32; the bytes are small (Q is K*H*U floats, read once).  At the
// main path's K=16384 the grid is 128 blocks of 128 threads on 132 SMs,
// one warp a scheduler, so nothing hides the chain's latency.  The design
// shortens the chain, as K5's (cem_core.cuh) does:
// - The step is short_step.cuh's: the plant evaluation is derivs_short
//   (plants.cuh), one sincosf and one division, with the reciprocals of
//   the masses taken once a rollout; the stage cost shares the first
//   evaluation's cos(theta).  K5 and K6 take the same step, so their costs
//   equal this kernel's over the controls that their regenerations draw
//   again.
// - The next step's control is loaded while the current step runs, so no
//   step waits at its head for a load.
//
// Q is read strided in its [K, H, U] layout (thread k walks row k) instead
// of being transposed to [H, U, K] in the wrapper: a warp's loads at step h
// touch 32 sectors, but each 32-byte sector also holds the next steps'
// controls, which the following iterations then find in L1, so the extra
// transpose pass over Q would buy little.
#include "short_step.cuh"

namespace ctt {

// The body of both kernels: the cost of rollout k and, where Emit, its
// terminal state written to x_term [K, S].
template <class Plant, bool Rows, bool Emit>
__device__ __forceinline__ void cost_rollout_body(const float* __restrict__ s0,
                                                  const float* __restrict__ Q,
                                                  const float* __restrict__ pvec,
                                                  float* __restrict__ cost,
                                                  float* __restrict__ x_term, int K, int ks,
                                                  int H, const StepConsts& c, float max_cost) {
  constexpr int S = Plant::S, U = Plant::U;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  float p[Plant::kN];
  load_params<Plant>(Rows ? pvec + static_cast<size_t>(k / ks) * Plant::kN : pvec, p);
  const typename Plant::Recips rc = Plant::recips(p);
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(k) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = p[Plant::kUPrev + j];
  const float* q = Q + static_cast<size_t>(k) * H * U;
  float u_next[U];
#pragma unroll
  for (int j = 0; j < U; ++j) u_next[j] = __ldg(q + j);  // H >= 1 (the wrapper checks)
  for (int h = 0; h < H; ++h) {
    float u[U];
    const int ahead = h + 1 < H ? h + 1 : h;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = u_next[j];
      u_next[j] = __ldg(q + ahead * U + j);
    }
    short_step<Plant>(x, u, prev, acc, p, rc, c, max_cost);
  }
  cost[k] = (acc + Plant::terminal_cost(x, p)) / static_cast<float>(H + 1);
  if constexpr (Emit) {
#pragma unroll
    for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(k) * S + i] = x[i];
  }
}

template <class Plant, bool Rows>
__global__ void __launch_bounds__(kThreads)
cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                    const float* __restrict__ pvec, float* __restrict__ cost,
                    int K, int ks, int H, StepConsts c, float max_cost) {
  cost_rollout_body<Plant, Rows, false>(s0, Q, pvec, cost, nullptr, K, ks, H, c, max_cost);
}

// The emit_terminal form (pallas_rollout.py:48, :137-148): one session's
// costs and terminal states x_term [K, S], rollout k's state in row k.
template <class Plant>
__global__ void __launch_bounds__(kThreads)
cost_rollout_emit_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                         const float* __restrict__ pvec, float* __restrict__ cost,
                         float* __restrict__ x_term, int K, int H, StepConsts c,
                         float max_cost) {
  cost_rollout_body<Plant, false, true>(s0, Q, pvec, cost, x_term, K, K, H, c, max_cost);
}

// Its session-row form (slot_keys + emit_terminal, pallas_rollout.py:47-48):
// B sessions of ks rollouts, rollout k reading row k / ks of pvec; the
// gradient fleets' final scoring under a learned value terminal.
template <class Plant>
__global__ void __launch_bounds__(kThreads)
cost_rollout_emit_rows_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                              const float* __restrict__ pvec, float* __restrict__ cost,
                              float* __restrict__ x_term, int K, int ks, int H, StepConsts c,
                              float max_cost) {
  cost_rollout_body<Plant, true, true>(s0, Q, pvec, cost, x_term, K, ks, H, c, max_cost);
}

// K1, or its emit_terminal form where x_term is not null, over `Plant`.
template <class Plant>
int launch_cost_rollout(dim3 grid, cudaStream_t st, const float* s0, const float* Q,
                        const float* pvec, float* cost, float* x_term, int K, int ks, int H,
                        const StepConsts& c, float max_cost) {
  if (x_term != nullptr && ks == K) {
    cost_rollout_emit_kernel<Plant><<<grid, kThreads, 0, st>>>(s0, Q, pvec, cost, x_term, K, H,
                                                                c, max_cost);
  } else if (x_term != nullptr) {
    cost_rollout_emit_rows_kernel<Plant><<<grid, kThreads, 0, st>>>(s0, Q, pvec, cost, x_term,
                                                                     K, ks, H, c, max_cost);
  } else {
    (ks == K ? cost_rollout_kernel<Plant, false>
             : cost_rollout_kernel<Plant, true>)<<<grid, kThreads, 0, st>>>(s0, Q, pvec, cost, K,
                                                                            ks, H, c, max_cost);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's single-session kernel over `Plant`, the only form that this
// slice's plants carry.
template <class Plant>
int launch_cost_rollout_single(dim3 grid, cudaStream_t st, const float* s0, const float* Q,
                               const float* pvec, float* cost, int K, int H,
                               const StepConsts& c, float max_cost) {
  cost_rollout_kernel<Plant, false><<<grid, kThreads, 0, st>>>(s0, Q, pvec, cost, K, K, H, c,
                                                               max_cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Launches K1 on `stream` over K rollouts, sessions of ks (pvec holds
// K / ks rows, rollout k reading row k / ks: ks = K for one session, the
// session-row form for a fleet), or, with x_term not null, its
// emit_terminal form (its session-row form where ks < K), which also writes
// the terminal states [K, S] there; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unknown plant, a ks that does not
// divide K, or a form that the plant has no instance of: the pendulum,
// acrobot and point-mass plants take ks = K and no x_term).
extern "C" int ctt_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                void* cost, void* x_term, int K, int ks, int H, int rk4,
                                int substeps, float sub_dt, float half_dt, float dt6,
                                float max_cost, void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s0f = static_cast<const float*>(s0);
  const auto* qf = static_cast<const float*>(Q);
  const auto* pf = static_cast<const float*>(pvec);
  auto* costf = static_cast<float*>(cost);
  auto* xf = static_cast<float*>(x_term);
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_cost_rollout<ctt::CartpolePlant>(grid, st, s0f, qf, pf, costf, xf, K, ks,
                                                          H, c, max_cost);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_cost_rollout<ctt::CartpoleFastPlant>(grid, st, s0f, qf, pf, costf, xf,
                                                              K, ks, H, c, max_cost);
    default:
      if (xf != nullptr || ks != K) return static_cast<int>(cudaErrorInvalidValue);
      return ctt::with_slice_plant(plant, [&](auto plant_tag) {
        return ctt::launch_cost_rollout_single<decltype(plant_tag)>(grid, st, s0f, qf, pf, costf,
                                                                    K, H, c, max_cost);
      });
  }
}

// Blocks of the single-session K1 over `plant` that one SM holds (0 where
// the runtime cannot say or the plant has no instance).
extern "C" int ctt_cost_rollout_plant_blocks_per_sm(int plant) {
  auto blocks_of = [](auto plant_tag) {
    int blocks = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, ctt::cost_rollout_kernel<decltype(plant_tag), false>, ctt::kThreads,
               0) == cudaSuccess ? blocks : 0;
  };
  if (plant == ctt::kPlantCartpole) return blocks_of(ctt::CartpolePlant{});
  if (plant == ctt::kPlantCartpoleFast) return blocks_of(ctt::CartpoleFastPlant{});
  return ctt::is_slice_plant(plant) ? ctt::with_slice_plant(plant, blocks_of) : 0;
}

// Blocks of K1 (rows 0) or of its session-row form (rows 1) that one SM
// holds (0 where the runtime cannot say).
extern "C" int ctt_cost_rollout_blocks_per_sm(int rows) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks,
          rows ? ctt::cost_rollout_kernel<ctt::CartpolePlant, true>
               : ctt::cost_rollout_kernel<ctt::CartpolePlant, false>,
          ctt::kThreads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}
