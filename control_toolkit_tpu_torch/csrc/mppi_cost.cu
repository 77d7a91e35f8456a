// K2: the semi-fused MPPI cost — interpolation of inducing-point noise,
// clip, rollout, stage cost and MPPI correction cost, fused per rollout.
//
// Replaces control_toolkit_tpu/ops/pallas_mppi.py:make_cost_run
// (make_run.external, kernel body kernel1_ext over rollout_cost_core), the
// default MPPI step's kernel.  Python wrapper and plain version:
// ops/mppi_cost.py.
//
// The body is mppi_ahead.cuh's, K3's pass 1, with the noise read instead of
// drawn: EpsNoise reads e[p, j] = eps[(p*U + j)*K + k] from eps [P, U, K],
// already scaled, P*U loads a rollout, one each time the bracket moves.
// K4 (mppi_cost_cols.cu) runs the same body per session.
//
// What bounds it on an H100: each rollout's serial H-step rk4 chain, as
// K1's (cost_rollout.cu): at K=16384 the grid is 128 blocks of 128 threads
// on 132 SMs, one warp a scheduler, so nothing hides a step's latency; the
// bytes are eps and the costs.  The design takes all but the step off that
// chain: per chunk of 64 steps a prologue walks the bracket, reads W, u_nom
// and the noise, writes the clipped controls into the thread's column of
// shared memory and sums the correction; then cem_core.cuh:column_steps
// runs short_step.cuh's step over them.  At cc_weight 0 its costs equal
// K1's over mppi_controls_plain's controls bit for bit.
//
// The pendulum, acrobot and point-mass plants (plants.cuh) take this
// kernel alone, over short_step.cuh's stage cost and integrate; the
// point mass's two inputs halve the controls-ahead chunk (kDrawControls /
// U = 32 steps).
//
// Its emit_terminal form (kernel1_ext_emit, pallas_mppi.py:277; make_cost_run's
// emit_terminal, :501, :538-560), the main path's kernel under a learned
// value terminal, is the body's Emit instance: it also writes rollout k's
// terminal state x_H to row k of x_term [K, S], the rollout whose cost is
// cost[k] (the JAX kernel's [S, ROWS, C] tiles hold rollout t*tile + r*C +
// c at [:, r, t*C + c]); the optimizer adds V(x_H)/(H+1) to the costs
// before the softmax.  Its costs are K2's bit for bit.
#include "mppi_ahead.cuh"

namespace ctt {

// Thread g owns rollout g; its column of the block's shared array is
// threadIdx.x's.  Threads past K (ragged K) repeat rollout K-1 and write
// nothing.
template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
mppi_cost_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                 const float* __restrict__ pvec, const float* __restrict__ eps,
                 const float* __restrict__ W, const float* __restrict__ low,
                 const float* __restrict__ high, float* __restrict__ cost, int K, int H, int P,
                 StepConsts c, float max_cost, MppiCorr cc) {
  __shared__ float controls[kDrawControls][kCemThreads];
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < K ? g : K - 1;
  const EpsNoise noise{eps, gc, K, Plant::U};
  const float out = mppi_ahead_cost<Plant>(s0, u_nom, pvec, W, low, high, noise, H, P, c,
                                           max_cost, cc, &controls[0][threadIdx.x]);
  if (g < K) cost[g] = out;
}

// K2's emit_terminal form: K2's costs and the terminal states x_term [K, S].
template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
mppi_cost_emit_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                      const float* __restrict__ pvec, const float* __restrict__ eps,
                      const float* __restrict__ W, const float* __restrict__ low,
                      const float* __restrict__ high, float* __restrict__ cost,
                      float* __restrict__ x_term, int K, int H, int P, StepConsts c,
                      float max_cost, MppiCorr cc) {
  constexpr int S = Plant::S;
  __shared__ float controls[kDrawControls][kCemThreads];
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < K ? g : K - 1;
  const EpsNoise noise{eps, gc, K, Plant::U};
  float xh[S];
  const float out = mppi_ahead_cost<Plant, EpsNoise, true>(
      s0, u_nom, pvec, W, low, high, noise, H, P, c, max_cost, cc, &controls[0][threadIdx.x],
      xh);
  if (g < K) {
    cost[g] = out;
#pragma unroll
    for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(g) * S + i] = xh[i];
  }
}

// K2, or its emit_terminal form where x_term is not null, over `Plant`.
template <class Plant>
int launch_mppi_cost(dim3 grid, cudaStream_t st, const void* s0, const void* u_nom,
                     const void* pvec, const void* eps, const void* W, const void* low,
                     const void* high, void* cost, void* x_term, int K, int H, int P,
                     const StepConsts& c, float max_cost, const MppiCorr& cc) {
  if (x_term != nullptr) {
    mppi_cost_emit_kernel<Plant><<<grid, kCemThreads, 0, st>>>(
        static_cast<const float*>(s0), static_cast<const float*>(u_nom),
        static_cast<const float*>(pvec), static_cast<const float*>(eps),
        static_cast<const float*>(W), static_cast<const float*>(low),
        static_cast<const float*>(high), static_cast<float*>(cost), static_cast<float*>(x_term),
        K, H, P, c, max_cost, cc);
  } else {
    mppi_cost_kernel<Plant><<<grid, kCemThreads, 0, st>>>(
        static_cast<const float*>(s0), static_cast<const float*>(u_nom),
        static_cast<const float*>(pvec), static_cast<const float*>(eps),
        static_cast<const float*>(W), static_cast<const float*>(low),
        static_cast<const float*>(high), static_cast<float*>(cost), K, H, P, c, max_cost, cc);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K2 over `Plant` that one SM holds (0 where the runtime cannot
// say).
template <class Plant>
int mppi_cost_blocks_per_sm() {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mppi_cost_kernel<Plant>,
                                                       kCemThreads, 0) == cudaSuccess
             ? blocks
             : 0;
}

}  // namespace ctt

// Launches K2 on `stream`, or, with x_term not null, its emit_terminal form,
// which also writes the terminal states [K, S] there; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// plant, or for x_term over a plant whose emit_terminal form is not
// instantiated: the pendulum, acrobot and point-mass plants carry K2 alone).
extern "C" int ctt_mppi_cost(int plant, const void* s0, const void* u_nom, const void* pvec,
                             const void* eps, const void* W, const void* low, const void* high,
                             void* cost, void* x_term, int K, int H, int P, int rk4,
                             int substeps, float sub_dt, float half_dt, float dt6,
                             float max_cost, float cc_weight, float c1, float r, float c3,
                             void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const ctt::MppiCorr cc{cc_weight, c1, r, c3};
  constexpr int per_block = ctt::kCemThreads;
  const dim3 grid((K + per_block - 1) / per_block);
  auto st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_mppi_cost<ctt::CartpolePlant>(grid, st, s0, u_nom, pvec, eps, W, low,
                                                       high, cost, x_term, K, H, P, c, max_cost,
                                                       cc);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_mppi_cost<ctt::CartpoleFastPlant>(grid, st, s0, u_nom, pvec, eps, W,
                                                           low, high, cost, x_term, K, H, P, c,
                                                           max_cost, cc);
    default:
      if (x_term != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return ctt::with_slice_plant(plant, [&](auto plant_tag) {
        ctt::mppi_cost_kernel<decltype(plant_tag)><<<grid, ctt::kCemThreads, 0, st>>>(
            static_cast<const float*>(s0), static_cast<const float*>(u_nom),
            static_cast<const float*>(pvec), static_cast<const float*>(eps),
            static_cast<const float*>(W), static_cast<const float*>(low),
            static_cast<const float*>(high), static_cast<float*>(cost), K, H, P, c, max_cost, cc);
        return static_cast<int>(cudaGetLastError());
      });
  }
}

// Blocks of K2 over `plant` that one SM holds (0 where the runtime cannot
// say or the plant has no instance).
extern "C" int ctt_mppi_cost_plant_blocks_per_sm(int plant) {
  if (plant == ctt::kPlantCartpole) return ctt::mppi_cost_blocks_per_sm<ctt::CartpolePlant>();
  if (plant == ctt::kPlantCartpoleFast) {
    return ctt::mppi_cost_blocks_per_sm<ctt::CartpoleFastPlant>();
  }
  if (!ctt::is_slice_plant(plant)) return 0;
  return ctt::with_slice_plant(plant, [](auto plant_tag) {
    return ctt::mppi_cost_blocks_per_sm<decltype(plant_tag)>();
  });
}
