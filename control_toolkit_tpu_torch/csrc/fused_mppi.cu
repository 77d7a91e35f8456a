// K3: fully-fused MPPI — two passes over the same counter-PRNG noise.
//
// Replaces control_toolkit_tpu/ops/pallas_mppi.py:build_fused_mppi_step's
// make_run (:376, single-device form): kernel1 (:255, call :436) and
// kernel2 (:356, call :455).  Python wrappers, plain versions and the glue
// between the passes: ops/fused_mppi.py.
//
// Thread g owns rollout g of the JAX cost order (counter_prng.cuh
// tile_coords: sublane r, tile t, lane c, C = tile_k / 8).  Its noise at
// inducing point p and input j is
//   e[p,j] = stdev * counter_normal(seed*FNV + (off+t)*P*tile_k*U + j*P*tile_k
//                                   + p*tile_k + r*C + c)
// ((p*8 + r)*C + c in the JAX layout, uint32 arithmetic).
//
// Pass 1 (fused_mppi_cost_kernel) is mppi_ahead.cuh's rollout cost (K2's
// function, mppi_cost.cu) over that noise, drawn in the kernel instead of
// read: at step h, d_j = W[p0,h]*e[p0,j] + W[p1,h]*e[p1,j] over the two
// inducing points bracketing h, then clip, rollout, stage cost and MPPI
// correction cost.  The bracket's two normals per input are kept in
// registers and one new normal is drawn each time the bracket moves, so
// each thread draws P*U normals, not 2*H*U.  The noise scale and the
// interpolation are rounded as torch rounds them (no FMA contraction), so
// the plain version draws the same controls, and K1 over them
// (mppi_controls_plain) scores them as this pass does at cc_weight = 0.
//
// Over the fast plant (CartpoleFastPlant, the ":fast" predictors) both
// passes draw the fast normals (counter_normal<true>, JAX's fast_sampling):
// pass 1 through its plant's kFast, pass 2 as its own entry
// (fused_mppi_weights_fast_kernel).  Pass 1 also serves the pendulum,
// acrobot and point-mass plants (plants.cuh, with their fast plants), over
// short_step.cuh's stage cost and integrate; the point mass has no fast
// plant (its exact dynamics double as the fast ones), so pass 1's entry
// takes a `fast` flag, which must match a plant's fast plant and picks, for
// the point mass, its fast-normals instance (FastNormalsOf: the exact
// dynamics under the fast normals, JAX's fast_sampling=pred.fast_math).
// The quadrotor, car and arm plants take the same pass 1, the fast
// plants over the fast normals.
//
// Between the passes, torch computes rho = min S and a = sum exp(-(S-rho)/LBD)
// on the card and passes them by pointer (red = [rho, a]): no host sync.
//
// Pass 2 (fused_mppi_weights_kernel): each thread draws its P*U normals
// again and weights them by w = exp(-(S-rho)/LBD)/a; the block reduces
// w*z for each (p, j), warp shuffles then the warps' sums in shared memory
// in warp order (no float atomics: the result does not depend on
// scheduling), into partials [n_blocks, P, U].  Torch sums the partials and
// applies W and stdev once, b[h,j] = sum_p W[p,h]*stdev*sum_k w_k z_k[p,j]:
// the linearity of interpolation that the JAX module's header states; its
// eyemask/blocksum matmuls were Mosaic workarounds and are not carried over.
//
// What bounds it on an H100: pass 1 the serial rk4 chain, as K1's (one
// warp a scheduler at K=16384; mppi_ahead.cuh takes the draws, the
// interpolation and the correction off it, and the step is short_step.cuh's;
// it took 0.0935 ms with the draws inside the chain and rollout_core.cuh's
// step); pass 2 the P*U normals (two splitmix32 hashes, a
// logf, sqrtf and cosf each) and an expf per rollout, then 5 shuffles per
// (p, j) and warp.  The bytes are the [K] costs, read once by pass 2.
#include "mppi_ahead.cuh"

namespace ctt {

// The first counter of rollout g's noise, and the counter stride of one
// input (P*tile_k): e[p,j] reads base + j*stride + p*tile_k.
__device__ __forceinline__ uint32_t noise_base(const int* seed2, int g, int K, int tile_k,
                                               uint32_t stride, int U) {
  const int C = tile_k / kRows;
  const TileCoords tc = tile_coords(g, K, C);
  return static_cast<uint32_t>(__ldg(seed2)) * kFnv +
         (static_cast<uint32_t>(__ldg(seed2 + 1)) + tc.t) * (stride * static_cast<uint32_t>(U)) +
         tc.r * static_cast<uint32_t>(C) + tc.c;
}

// Pass 1's noise policy (mppi_ahead.cuh): e[p,j] = stdev * the counter
// normal (Fast: the fast normal), the product rounded.
template <bool Fast>
struct CounterNoise {
  uint32_t base, stride, tile_k;
  float stdev;

  __device__ __forceinline__ float operator()(int p, int j) const {
    return __fmul_rn(counter_normal<Fast>(base + static_cast<uint32_t>(j) * stride +
                                          static_cast<uint32_t>(p) * tile_k),
                     stdev);
  }
};

// Thread g of the grid owns rollout g of the cost order; its column of the
// block's shared array is threadIdx.x's.  Threads past K (ragged K) repeat
// rollout K-1 and write nothing.
template <class Plant>
__global__ void __launch_bounds__(kCemThreads)
fused_mppi_cost_kernel(const float* __restrict__ s0, const float* __restrict__ u_nom,
                       const float* __restrict__ pvec, const int* __restrict__ seed2,
                       const float* __restrict__ W, const float* __restrict__ low,
                       const float* __restrict__ high, float* __restrict__ cost, int K, int H,
                       int P, int tile_k, StepConsts c, float max_cost, MppiCorr cc,
                       float stdev) {
  __shared__ float controls[kDrawControls][kCemThreads];
  const int g = blockIdx.x * kCemThreads + threadIdx.x, gc = g < K ? g : K - 1;
  const uint32_t stride = static_cast<uint32_t>(P) * static_cast<uint32_t>(tile_k);
  const CounterNoise<Plant::kFast> noise{noise_base(seed2, gc, K, tile_k, stride, Plant::U),
                                         stride, static_cast<uint32_t>(tile_k), stdev};
  const float out = mppi_ahead_cost<Plant>(s0, u_nom, pvec, W, low, high, noise, H, P, c,
                                           max_cost, cc, &controls[0][threadIdx.x]);
  if (g < K) cost[g] = out;
}

constexpr int kWarps = kThreads / 32;

// Pass 2's body over the block's warp_sums (kWarps * P * U floats of
// dynamic shared memory); Fast: the fast normals.
template <bool Fast>
__device__ __forceinline__ void fused_mppi_weights_body(
    const int* __restrict__ seed2, const float* __restrict__ cost, const float* __restrict__ red,
    float* __restrict__ partials, int K, int P, int U, int tile_k, float inv_lbd) {
  extern __shared__ float warp_sums[];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int PU = P * U;
  const bool live = g < K;  // ragged K: the block's tail adds zeros
  const uint32_t stride = static_cast<uint32_t>(P) * static_cast<uint32_t>(tile_k);
  float w = 0.0f;
  uint32_t base = 0;
  if (live) {
    w = expf(-(__ldg(cost + g) - __ldg(red)) * inv_lbd) / __ldg(red + 1);
    base = noise_base(seed2, g, K, tile_k, stride, U);
  }
  for (int q = 0; q < PU; ++q) {
    const int pp = q / U, j = q % U;
    float v = 0.0f;
    if (live) {
      v = w * counter_normal<Fast>(base + static_cast<uint32_t>(j) * stride +
                                   static_cast<uint32_t>(pp * tile_k));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp * PU + q] = v;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < PU; q += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += warp_sums[k * PU + q];
    partials[static_cast<size_t>(blockIdx.x) * PU + q] = s;
  }
}

// Dynamic shared memory: kWarps * P * U floats.
__global__ void __launch_bounds__(kThreads)
fused_mppi_weights_kernel(const int* __restrict__ seed2, const float* __restrict__ cost,
                          const float* __restrict__ red, float* __restrict__ partials, int K,
                          int P, int U, int tile_k, float inv_lbd) {
  fused_mppi_weights_body<false>(seed2, cost, red, partials, K, P, U, tile_k, inv_lbd);
}

// Pass 2 of the fast plant's K3 (the JAX fast_sampling form): the fast
// normals, its own entry so that pass 2 keeps its code.
__global__ void __launch_bounds__(kThreads)
fused_mppi_weights_fast_kernel(const int* __restrict__ seed2, const float* __restrict__ cost,
                               const float* __restrict__ red, float* __restrict__ partials, int K,
                               int P, int U, int tile_k, float inv_lbd) {
  fused_mppi_weights_body<true>(seed2, cost, red, partials, K, P, U, tile_k, inv_lbd);
}

// Pass 1 of `Plant` on `stream`.
template <class Plant>
int launch_fused_mppi_cost(dim3 grid, cudaStream_t st, const void* s0, const void* u_nom,
                           const void* pvec, const void* seed2, const void* W, const void* low,
                           const void* high, void* cost, int K, int H, int P, int tile_k,
                           const StepConsts& c, float max_cost, const MppiCorr& cc,
                           float stdev) {
  fused_mppi_cost_kernel<Plant><<<grid, kCemThreads, 0, st>>>(
      static_cast<const float*>(s0), static_cast<const float*>(u_nom),
      static_cast<const float*>(pvec), static_cast<const int*>(seed2),
      static_cast<const float*>(W), static_cast<const float*>(low),
      static_cast<const float*>(high), static_cast<float*>(cost), K, H, P, tile_k, c, max_cost,
      cc, stdev);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// Launch K3's pass 1 on `stream`, over the fast normals where `fast` (a
// fast plant, or the point mass's fast-normals instance); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// plant or a `fast` that does not fit it).
extern "C" int ctt_fused_mppi_cost(int plant, const void* s0, const void* u_nom, const void* pvec,
                                   const void* seed2, const void* W, const void* low,
                                   const void* high, void* cost, int K, int H, int P, int tile_k,
                                   int rk4, int substeps, float sub_dt, float half_dt, float dt6,
                                   float max_cost, float cc_weight, float c1, float r, float c3,
                                   float stdev, int fast, void* stream) {
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const ctt::MppiCorr cc{cc_weight, c1, r, c3};
  constexpr int per_block = ctt::kCemThreads;
  const dim3 grid((K + per_block - 1) / per_block);
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto instance_tag) {
    return ctt::launch_fused_mppi_cost<decltype(instance_tag)>(
        grid, st, s0, u_nom, pvec, seed2, W, low, high, cost, K, H, P, tile_k, c, max_cost, cc,
        stdev);
  };
  return ctt::with_fused_instance(plant, fast, launch);
}

// Blocks of pass 1 over `plant` (its fast-normals instance where `fast`)
// that one SM holds (0 where the runtime cannot say or the plant is
// unknown; the caller passes the plant's own `fast`).
extern "C" int ctt_fused_mppi_cost_plant_blocks_per_sm(int plant, int fast) {
  int blocks = 0;
  const int rc = ctt::with_fused_instance(plant, fast, [&](auto instance_tag) {
    return ctt::blocks_per_sm(ctt::fused_mppi_cost_kernel<decltype(instance_tag)>,
                              ctt::kCemThreads, blocks);
  });
  return rc == 0 ? blocks : 0;
}

// Launch K3's pass 2 on `stream` into partials [ceil(K / 128), P, U], over
// the fast normals where `fast` (pass 1's plant the fast one); returns
// cudaGetLastError() after the launch.
extern "C" int ctt_fused_mppi_weights(const void* seed2, const void* cost, const void* red,
                                      void* partials, int K, int P, int U, int tile_k,
                                      float inv_lbd, int fast, void* stream) {
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  const size_t smem = sizeof(float) * ctt::kWarps * P * U;
  (fast ? ctt::fused_mppi_weights_fast_kernel
        : ctt::fused_mppi_weights_kernel)<<<grid, ctt::kThreads, smem,
                                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed2), static_cast<const float*>(cost),
      static_cast<const float*>(red), static_cast<float*>(partials), K, P, U, tile_k, inv_lbd);
  return static_cast<int>(cudaGetLastError());
}
