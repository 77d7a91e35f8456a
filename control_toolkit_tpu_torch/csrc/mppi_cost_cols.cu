// K4: the semi-fused MPPI cost of B independent sessions in one launch —
// K2's body (mppi_ahead.cuh over EpsNoise) with each session's own initial
// state, shifted nominal plan, packed parameters (attributes, previous
// control, per-slot dynamics constants) and noise.
//
// Replaces control_toolkit_tpu/ops/pallas_mppi.py:make_cost_run_cols
// (make_run.cols, kernel body kernel1_cols), the batched-mpc controller's
// MPPI kernel.  Python wrapper and plain version: ops/mppi_cost_cols.py.
//
// Thread g owns rollout k = g % K of session b = g / K and reads the
// session's rows by index: s0 [B, S], u_nom [B, H, U], pvec_b [B, N],
// eps [B, P, U, K] (rollout fastest, so a warp's loads of one (b, p, j)
// coalesce), cost [B, K].  Blocks of 128 threads may straddle sessions;
// threads past B*K repeat the last rollout and write nothing.  The TPU
// kernel's per-column context rows and its lane-tile layout are not
// carried over: session b's rollout k is the JAX layout's (r, cw) with
// k = r*(K/8) + cw (ops/mppi_cost_cols.py).  Every scalar is read at run
// time from pvec_b, so a changed length, target or weight never rebuilds
// anything.
//
// What bounds it on an H100: K2's, each rollout's serial H-step rk4 chain,
// with the controls and the correction computed ahead of it and
// short_step.cuh's step (mppi_ahead.cuh); at B=128, K=512 the grid is 512
// blocks of 128 threads on 132 SMs, four times K2's fill at K=16384, so
// the SMs' issue throughput starts to bind, as it does for K6
// (fused_cem_cols.cu) on the same body's chain.
//
// Its emit_terminal form (kernel1_cols_emit, pallas_mppi.py:350;
// make_cost_run_cols' emit_terminal, :586), the fleet's kernel under a
// learned value terminal, is the body's Emit instance (mppi_ahead.cuh): it
// also writes session b's rollout k's terminal state to row b*K + k of
// x_term [B*K, S], the row of cost[b, k]; the optimizer adds each
// session's V(x_H)/(H+1) before its softmax.  Its costs are K4's bit for
// bit.
//
// K4 and its emit_terminal form carry every ODE plant of plants.cuh (the
// pendulum, acrobot, point-mass, quadrotor, car and arm plants, with their
// fast plants: K2's body carries them already).
#include "mppi_ahead.cuh"

namespace ctt {

template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
mppi_cost_cols_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                      const float* __restrict__ pvec_b, const float* __restrict__ eps,
                      const float* __restrict__ W, const float* __restrict__ low,
                      const float* __restrict__ high, float* __restrict__ cost, int B, int K,
                      int H, int P, StepConsts c, float max_cost, MppiCorr cc) {
  constexpr int S = Plant::S, U = Plant::U;
  __shared__ float controls[kDrawControls][kCemThreads];
  const int n = B * K;
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < n ? g : n - 1;
  const int b = gc / K;
  const EpsNoise noise{eps + static_cast<size_t>(b) * P * U * K, gc - b * K, K, U};
  const float out = mppi_ahead_cost<Plant>(
      s0 + static_cast<size_t>(b) * S, u_nom + static_cast<size_t>(b) * H * U,
      pvec_b + static_cast<size_t>(b) * Plant::kN, W, low, high, noise, H, P, c, max_cost, cc,
      &controls[0][threadIdx.x]);
  if (g < n) cost[g] = out;
}

// K4's emit_terminal form: K4's costs and the terminal states
// x_term [B*K, S].
template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
mppi_cost_cols_emit_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                           const float* __restrict__ pvec_b, const float* __restrict__ eps,
                           const float* __restrict__ W, const float* __restrict__ low,
                           const float* __restrict__ high, float* __restrict__ cost,
                           float* __restrict__ x_term, int B, int K, int H, int P, StepConsts c,
                           float max_cost, MppiCorr cc) {
  constexpr int S = Plant::S, U = Plant::U;
  __shared__ float controls[kDrawControls][kCemThreads];
  const int n = B * K;
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < n ? g : n - 1;
  const int b = gc / K;
  const EpsNoise noise{eps + static_cast<size_t>(b) * P * U * K, gc - b * K, K, U};
  float xh[S];
  const float out = mppi_ahead_cost<Plant, EpsNoise, true>(
      s0 + static_cast<size_t>(b) * S, u_nom + static_cast<size_t>(b) * H * U,
      pvec_b + static_cast<size_t>(b) * Plant::kN, W, low, high, noise, H, P, c, max_cost, cc,
      &controls[0][threadIdx.x], xh);
  if (g < n) {
    cost[g] = out;
#pragma unroll
    for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(g) * S + i] = xh[i];
  }
}

// K4, or its emit_terminal form where x_term is not null, over `Plant`.
template <class Plant>
int launch_mppi_cost_cols(dim3 grid, cudaStream_t st, const void* s0, const void* u_nom,
                          const void* pvec_b, const void* eps, const void* W, const void* low,
                          const void* high, void* cost, void* x_term, int B, int K, int H, int P,
                          const StepConsts& c, float max_cost, const MppiCorr& cc) {
  if (x_term != nullptr) {
    mppi_cost_cols_emit_kernel<Plant><<<grid, kCemThreads, 0, st>>>(
        static_cast<const float*>(s0), static_cast<const float*>(u_nom),
        static_cast<const float*>(pvec_b), static_cast<const float*>(eps),
        static_cast<const float*>(W), static_cast<const float*>(low),
        static_cast<const float*>(high), static_cast<float*>(cost), static_cast<float*>(x_term),
        B, K, H, P, c, max_cost, cc);
    return static_cast<int>(cudaGetLastError());
  }
  mppi_cost_cols_kernel<Plant><<<grid, kCemThreads, 0, st>>>(
      static_cast<const float*>(s0), static_cast<const float*>(u_nom),
      static_cast<const float*>(pvec_b), static_cast<const float*>(eps),
      static_cast<const float*>(W), static_cast<const float*>(low),
      static_cast<const float*>(high), static_cast<float*>(cost), B, K, H, P, c, max_cost, cc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Launches K4 on `stream`, or, with x_term not null, its emit_terminal
// form, which also writes the terminal states [B*K, S] there; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// plant).
extern "C" int ctt_mppi_cost_cols(int plant, const void* s0, const void* u_nom,
                                  const void* pvec_b, const void* eps, const void* W,
                                  const void* low, const void* high, void* cost, void* x_term,
                                  int B, int K, int H, int P, int rk4, int substeps,
                                  float sub_dt, float half_dt, float dt6, float max_cost,
                                  float cc_weight, float c1, float r, float c3, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const ctt::MppiCorr cc{cc_weight, c1, r, c3};
  constexpr int per_block = ctt::kCemThreads;
  const dim3 grid((B * K + per_block - 1) / per_block);
  auto st = static_cast<cudaStream_t>(stream);
  return ctt::with_ode_plant(plant, [&](auto plant_tag) {
    return ctt::launch_mppi_cost_cols<decltype(plant_tag)>(grid, st, s0, u_nom, pvec_b, eps, W,
                                                           low, high, cost, x_term, B, K, H, P, c,
                                                           max_cost, cc);
  });
}

// Blocks of K4 over `plant` that one SM holds (0 where the runtime cannot
// say or the plant is unknown).
extern "C" int ctt_mppi_cost_cols_plant_blocks_per_sm(int plant) {
  int blocks = 0;
  const int rc = ctt::with_ode_plant(plant, [&](auto plant_tag) {
    return ctt::blocks_per_sm(ctt::mppi_cost_cols_kernel<decltype(plant_tag)>, ctt::kCemThreads,
                              blocks);
  });
  return rc == 0 ? blocks : 0;
}

// Blocks of K4's emit_terminal form over `plant` that one SM holds (0 where
// the runtime cannot say or the plant is unknown).
extern "C" int ctt_mppi_cost_cols_emit_plant_blocks_per_sm(int plant) {
  int blocks = 0;
  const int rc = ctt::with_ode_plant(plant, [&](auto plant_tag) {
    return ctt::blocks_per_sm(ctt::mppi_cost_cols_emit_kernel<decltype(plant_tag)>,
                              ctt::kCemThreads, blocks);
  });
  return rc == 0 ? blocks : 0;
}
