// K5: fully-fused CEM — the population drawn on the card from the counter
// PRNG, clipped, rolled out and scored; only the [K] costs leave the kernel.
//
// Replaces control_toolkit_tpu/ops/pallas_cem.py:build_fused_cem (kernel
// :89-121, call :133).  Python wrapper, plain version and the elite
// regeneration: ops/fused_cem.py.  The control of each counter is
// cem_core.cuh's cem_control, which K6 (fused_cem_cols.cu) shares.
//
// Rollout g follows the JAX cost order (counter_prng.cuh tile_coords:
// sublane r, tile t, lane c, C = tile_k / 8).  Its counters are
//   seed*FNV + (off+t)*H*tile_k*U + j*H*tile_k + h*tile_k + r*C + c
// in uint32 arithmetic (h*tile_k + r*C + c is (h*8 + r)*C + c).  seed2 =
// [seed, tile offset] is read from device memory: a seed drawn on the card
// is never copied to the host.
//
// What bounds it on an H100: each rollout's serial H-step rk4 chain, with
// one warp a scheduler at K=16384 (128 blocks of 128 threads on 132 SMs):
// nothing hides a step's latency, and the bytes are the [K] costs.  The
// design shortens the chain:
// - The draws leave it.  Before its steps, a rollout draws its controls
//   (two splitmix32 hashes, logf, sqrtf and cosf each) into its column of
//   shared memory, kDrawControls at a time: independent draws, unrolled,
//   issue back to back; then each step reads its control, the next one
//   loaded while the step runs.  The bits are cem_control's, so
//   ops/fused_cem.py:regen_controls still gives the scored controls.
// - The step is short_step.cuh's: the plant evaluation is derivs_short
//   (plants.cuh): sincosf reduces theta once, and the reciprocals of the
//   masses are taken once a rollout, so one division (num / den) a plant
//   evaluation stays of five; the stage cost takes its cos(theta) from the
//   first evaluation's sincosf.  On the main path (rk4, one sub-step) a
//   step is one straight run of code, so the stage cost's work fills the
//   rk4 chain's gaps.
// A rollout is a thread's.  (Two or four lanes a rollout, splitting its
// draws, gave the card 2x and 4x the warps but were 3% and 34% slower at
// K=16384: PERF.md.)
// Rollouts past K (a block's ragged edge) repeat rollout K-1 and write
// nothing.
#include "cem_core.cuh"
#include "short_step.cuh"

namespace ctt {

constexpr int kCemThreads = 128;   // threads a K5 block
constexpr int kDrawControls = 64;  // controls a rollout draws ahead, per chunk of steps

template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
fused_cem_kernel(const float* __restrict__ s0, const float* __restrict__ mue,
                 const float* __restrict__ std_dev, const float* __restrict__ pvec,
                 const int* __restrict__ seed2, const float* __restrict__ low,
                 const float* __restrict__ high, float* __restrict__ cost, int K, int H,
                 int tile_k, StepConsts c, float max_cost) {
  constexpr int S = Plant::S, U = Plant::U;
  constexpr int kSteps = kDrawControls / U;
  static_assert(kSteps >= 1, "a chunk holds a step");
  // Control j of chunk step i of the block's rollout `slot`: a column a
  // thread, which only that thread writes and reads.
  __shared__ float drawn[kSteps * U][kCemThreads];
  const int slot = threadIdx.x;
  const int g = blockIdx.x * kCemThreads + slot, gc = g < K ? g : K - 1;
  float p[Plant::kN];
  load_params<Plant>(pvec, p);
  const typename Plant::Recips rc = Plant::recips(p);
  float lo[U], hi[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    lo[j] = __ldg(low + j);
    hi[j] = __ldg(high + j);
  }
  const int C = tile_k / kRows;
  const TileCoords tc = tile_coords(gc, K, C);
  const uint32_t stride = static_cast<uint32_t>(H) * static_cast<uint32_t>(tile_k);
  const uint32_t base = static_cast<uint32_t>(__ldg(seed2)) * kFnv +
                        (static_cast<uint32_t>(__ldg(seed2 + 1)) + tc.t) * (stride * U) +
                        tc.r * static_cast<uint32_t>(C) + tc.c;
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = p[Plant::kUPrev + j];
  for (int h0 = 0; h0 < H; h0 += kSteps) {
    const int n = H - h0 < kSteps ? H - h0 : kSteps;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int h = h0 + i;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const uint32_t counter = base + static_cast<uint32_t>(j) * stride +
                                 static_cast<uint32_t>(h) * static_cast<uint32_t>(tile_k);
        drawn[i * U + j][slot] =
            cem_control(counter, __ldg(mue + h * U + j), __ldg(std_dev + h * U + j), lo[j], hi[j]);
      }
    }
    float u_next[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u_next[j] = drawn[j][slot];
    for (int i = 0; i < n; ++i) {
      float u[U];
      const int ahead = i + 1 < n ? i + 1 : i;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        u[j] = u_next[j];
        u_next[j] = drawn[ahead * U + j][slot];
      }
      short_step<Plant>(x, u, prev, acc, p, rc, c, max_cost);
    }
  }
  if (g < K) cost[g] = (acc + Plant::terminal_cost(x, p)) / static_cast<float>(H + 1);
}

}  // namespace ctt

// Launches K5 on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown plant).
extern "C" int ctt_fused_cem(int plant, const void* s0, const void* mue, const void* std_dev,
                             const void* pvec, const void* seed2, const void* low,
                             const void* high, void* cost, int K, int H, int tile_k, int rk4,
                             int substeps, float sub_dt, float half_dt, float dt6, float max_cost,
                             void* stream) {
  if (plant != ctt::kPlantCartpole) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  constexpr int per_block = ctt::kCemThreads;
  ctt::fused_cem_kernel<ctt::CartpolePlant>
      <<<(K + per_block - 1) / per_block, per_block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(s0), static_cast<const float*>(mue),
          static_cast<const float*>(std_dev), static_cast<const float*>(pvec),
          static_cast<const int*>(seed2), static_cast<const float*>(low),
          static_cast<const float*>(high), static_cast<float*>(cost), K, H, tile_k, c, max_cost);
  return static_cast<int>(cudaGetLastError());
}
