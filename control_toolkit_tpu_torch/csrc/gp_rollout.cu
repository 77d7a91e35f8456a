// K14 and K10: rollout + trajectory cost (K14), and the cost J with its
// gradient dJ/dQ in one forward-store / backward-sweep pass (K10), over K
// control sequences under sparse-GP dynamics (gp_core.cuh).
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_gp_cost_rollout_kernel (K14) and ops/pallas_grad.py:
// build_gp_grad_cost_rollout_kernel (K10), the kernels behind
// kernel_families/gp.py.  Python wrappers and plain versions:
// ops/gp_rollout.py and ops/gp_grad_cost_rollout.py.
//
// K14 and K10 serve one session (ks = K) or, in their session-row forms
// (the slot_keys forms, pallas_neural.py and pallas_grad.py:524), B
// sessions of ks rollouts in one launch, every lane of rollout k reading
// row k / ks of pvec; a warp's rollouts may straddle two sessions.
//
// K14's emit_terminal form (pallas_neural.py:657, :682, :721-726) serves a
// learned value terminal: the same costs and each rollout's state after
// step H written to x_term [K, S] by lane r = 0 of the rollout (the lane
// that writes cost[k]), rows past K writing nothing.  It is its own entry
// over K14's body (gp_cost_rollout_emit_kernel, the body's Emit instance),
// so the unvalued kernel's code stays as it was.
//
// K10's value_spec form (pallas_grad.py:119-141, :191-206; one session or
// the session-row form, at kGpLanes lanes a rollout) is its own entry over
// K10's body (gp_grad_cost_rollout_value_kernel): V's operands staged after
// the inducing points, lane r = 0 of a rollout evaluates V(x_H) and ct *
// dV/dx_H (value_mlp.cuh) and a shuffle gives the rollout's other lanes its
// bits, so all L go on with one lam.
//
// K14 is a one-thread-a-rollout cost kernel (as K1, cost_rollout.cu) with
// the GP step: the packed parameters are the cost's alone (plants.cuh
// CartpoleCost), the stage cost is taken before the step, cost[k] =
// (sum_h stage + terminal) / (H+1).  K10 is K7
// (grad_cost_rollout.cu) with the GP step and its adjoint (gp_core.cuh
// gp_step_vjp, transcribed from ops/adjoints.py gp_step_vjp): the forward
// sweep stores x_h in the wrapper-allocated xhist [H, S, K], then
// h = H-1 .. 0 with ct = 1/(H+1):
//   lam = ct * d terminal / d x_H
//   (dx, du) = gp_step_vjp at the stored x_h (the RBF row recomputed)
//   (gx, gu, gprev_h) = the stage cost's gradient at ct
//   dQ[k,h] = (du + gu) + gprev_{h+1}       gprev_H = 0
//   lam = dx + gx
//
// What bounds them on an H100: per rollout-step, a loop over the M inducing
// points, each a D-term dot product, an exp and S multiply-adds (about 25
// FP32 operations; K10's backward about 55 more); at the main path's
// K=16384, H=50, M=128 that is 2.6 GFLOP a call for K14 (0.04 ms at the
// 67 TFLOP/s FP32 peak) and about 8.5 GFLOP for K10.  The inducing points
// (M * 12 floats, 6 KB at M=128) are staged once a block and read from
// shared memory.  One thread a rollout left each thread a dependent FP32
// chain of M points a step, about four warps an SM at K=16384, and nothing
// hid it (K14 took 0.1975 ms so, K10 0.683).  So both kernels split each
// rollout's loop over the M points across L lanes of a warp (L a template
// parameter, a power of two; kGpThreads threads a block, so kGpThreads / L
// rollouts): L times the warps, each lane a chain M/L points long, then
// log2 L shuffle rounds a sum.  Every lane of a rollout carries the same x
// (and K10's lam and cotangent: the butterfly leaves the same bits on
// each); lane 0 alone stores the cost (and K10's xhist and dQ).  K14's
// cost and K10's J take the same stage cost and gp_step<S, U, L> (the
// butterfly pairs the lanes by r in the same order whatever their
// stride), so at one L they are equal bit for bit.  On an H100 80GB HBM3
// at 700 W (PERF.md):
// - K10 (a rollout's lanes adjacent) is bound by its instructions: at
//   K=16384, H=50, M=128 about 0.34 ms for the points' loops plus 0.01 ms
//   for each lane's copy of the per-step work (about 0.38 ms at L = 4,
//   0.42 at 8, 0.51 at 16, 0.70 at 32; one thread a rollout took 0.68),
//   and three 16-byte row loads a point or two and an 8-byte one time the
//   same.
// - K14, forward only, has fewer operations a row load.  With a rollout's
//   lanes adjacent each quarter of the warp reads L rows a load, and it
//   took 0.157, 0.151, 0.162 and 0.206 ms at L = 2, 4, 8 and 16.  Its
//   lanes are spread instead (lane r of the warp's rollout j at r * 32 / L
//   + j), so a quarter of the warp reads one row a load: 0.255, 0.163,
//   0.135, 0.151 and 0.186 ms at L = 1, 2, 4, 8 and 16 (at L = 1 a block
//   holds 256 rollouts, and K=16384 fills 64 of the 132 SMs).
#include "gp_core.cuh"
#include "value_mlp.cuh"

namespace ctt {

constexpr int kGpThreads = 256;  // threads a K14 or K10 block: kGpThreads / L rollouts
// K10's lanes a rollout where the caller leaves it to the kernel: the
// fastest of 4, 8, 16 and 32 at K=16384, H=50 over SGP_128 (H100 80GB
// HBM3, 700 W; PERF.md).
constexpr int kGpLanes = 4;
// K14's: the fastest of 1, 2, 4, 8 and 16 at K=16384, H=50 over SGP_128
// (H100 80GB HBM3, 700 W; PERF.md).
constexpr int kGpCostLanes = 4;

// K14's body with L lanes a rollout, spread over the warp: its R = 32 / L
// rollouts j take lanes j, j + R, .. (lane r of rollout j at r * R + j), so
// each quarter of the warp reads one inducing point's row a load.  Where
// Emit, lane r = 0 of rollout k also writes its terminal state to x_term
// [K, S] beside its cost.
template <class Cost, int L, bool Emit>
__device__ __forceinline__ void gp_cost_rollout_body(const float* __restrict__ s0,
                                                     const float* __restrict__ Q,
                                                     const float* __restrict__ pvec,
                                                     float* __restrict__ cost,
                                                     float* __restrict__ x_term, int K, int ks,
                                                     int H, float max_cost, const GPArgs& gp) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_gp<S, U>(sm, gp);
  __syncthreads();
  constexpr int R = 32 / L;
  const int t = blockIdx.x * blockDim.x + threadIdx.x, r = (t & 31) / R;
  if ((t & ~31) / L >= K) return;  // a warp with no rollout below K
  // Lanes past K (ragged K) repeat rollout K-1 for the shuffles and write
  // nothing.
  const int k = (t >> 5) * R + (t & (R - 1)), kc = k < K ? k : K - 1;
  GPConsts<S, U> g;
  g.load(gp);
  // Every lane of a rollout its session's row (ks rollouts a session).
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
    gp_step<S, U, L, R>(sm, gp.M, r, g, x, u);
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  if (r == 0 && k < K) {
    cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);
    if constexpr (Emit) {
#pragma unroll
      for (int i = 0; i < S; ++i) x_term[static_cast<size_t>(k) * S + i] = x[i];
    }
  }
}

template <class Cost, int L>
__global__ void __launch_bounds__(kGpThreads)
gp_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                       const float* __restrict__ pvec, float* __restrict__ cost, int K, int ks,
                       int H, float max_cost, GPArgs gp) {
  gp_cost_rollout_body<Cost, L, false>(s0, Q, pvec, cost, nullptr, K, ks, H, max_cost, gp);
}

// K14's emit_terminal form (pallas_neural.py:657): its costs and the
// terminal states x_term [K, S]; one session or the session-row form.
template <class Cost, int L>
__global__ void __launch_bounds__(kGpThreads)
gp_cost_rollout_emit_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                            const float* __restrict__ pvec, float* __restrict__ cost,
                            float* __restrict__ x_term, int K, int ks, int H, float max_cost,
                            GPArgs gp) {
  gp_cost_rollout_body<Cost, L, true>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, gp);
}

// K10's body with L lanes a rollout: lanes r = 0..L-1 of each aligned
// group of L in a warp share rollout k.  Its value_spec form (kValue)
// stages the value net of *v after the inducing points; lane r = 0 of a
// rollout evaluates V and its VJP at x_H in its column of kGpThreads / L
// and a shuffle gives the rollout's other lanes its bits, so all L go on
// with one lam.
template <class Cost, int L, bool kValue>
__device__ __forceinline__ void gp_grad_cost_rollout_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ dQ, float* __restrict__ xhist, int K, int ks,
    int H, float max_cost, float ct, const GPArgs& gp, const ValueArgs* v) {
  constexpr int S = Cost::S, U = Cost::U;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_gp<S, U>(sm, gp);
  float* vsm = nullptr;
  if constexpr (kValue) {
    vsm = sm + gp.M * GPRow<S, U>::kRow;
    stage_value_net(vsm, *v);
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x, r = threadIdx.x & (L - 1);
  if ((t & ~31) / L >= K) return;  // a warp with no rollout below K
  // Lanes past K (ragged K) repeat rollout K-1 for the shuffles and write
  // nothing.
  const int k = t / L, kc = k < K ? k : K - 1;
  const bool writes = r == 0 && k < K;
  GPConsts<S, U> g;
  g.load(gp);
  // Every lane of a rollout its session's row (ks rollouts a session).
  const float* row = pvec + static_cast<size_t>(kc / ks) * Cost::kN;
  float c[Cost::kN];
#pragma unroll
  for (int i = 0; i < Cost::kN; ++i) c[i] = __ldg(row + i);
  const float* q = Q + static_cast<size_t>(kc) * H * U;
  float* dq = dQ + static_cast<size_t>(kc) * H * U;

  // Forward sweep.
  float x[S], prev[U], acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = __ldg(s0 + static_cast<size_t>(kc) * S + i);
#pragma unroll
  for (int j = 0; j < U; ++j) prev[j] = c[Cost::kUPrev + j];
  for (int h = 0; h < H; ++h) {
    if (writes) {
#pragma unroll
      for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(h) * S + i) * K + k] = x[i];
    }
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    acc = acc + Cost::stage_cost(x, u, prev, c, max_cost);
    gp_step<S, U, L>(sm, gp.M, r, g, x, u);
#pragma unroll
    for (int j = 0; j < U; ++j) prev[j] = u[j];
  }
  float vgx[S];  // ct * dV/dx_H (the value_spec form)
  if constexpr (kValue) {
    const int lane = threadIdx.x & 31;
    const float value = value_from_lane<S, kGpThreads / L>(x, vsm, *v, lane & ~(L - 1),
                                                           threadIdx.x / L, ct, vgx);
    if (writes) {
      cost[k] = (acc + (Cost::terminal_cost(x, c) + value)) / static_cast<float>(H + 1);
    }
  } else {
    if (writes) cost[k] = (acc + Cost::terminal_cost(x, c)) / static_cast<float>(H + 1);
  }
  __syncwarp();  // lane 0's xhist stores, before the other lanes read them

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
    for (int i = 0; i < S; ++i) xh[i] = xhist[(static_cast<size_t>(h) * S + i) * K + kc];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      u[j] = __ldg(q + h * U + j);
      prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : c[Cost::kUPrev + j];
    }
    float dx[S], du[U], gx[S], gu[U], gp_[U];
    gp_step_vjp<S, U, L>(sm, gp.M, r, g, xh, u, lam, dx, du);
    Cost::stage_cost_vjp(xh, u, prev, c, ct, gx, gu, gp_);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (writes) dq[h * U + j] = (du[j] + gu[j]) + gnext[j];
      gnext[j] = gp_[j];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) lam[i] = dx[i] + gx[i];
  }
}

template <class Cost, int L>
__global__ void __launch_bounds__(kGpThreads)
gp_grad_cost_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                            const float* __restrict__ pvec, float* __restrict__ cost,
                            float* __restrict__ dQ, float* __restrict__ xhist, int K, int ks,
                            int H, float max_cost, float ct, GPArgs gp) {
  gp_grad_cost_rollout_body<Cost, L, false>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct,
                                            gp, nullptr);
}

// K10's value_spec form (pallas_grad.py:119-141, :191-206, the
// build_gp_grad_cost_rollout_kernel twin) at L lanes a rollout: one session
// or its session-row form, its own entry so that K10 keeps its code.
template <class Cost, int L>
__global__ void __launch_bounds__(kGpThreads)
gp_grad_cost_rollout_value_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                  const float* __restrict__ pvec, float* __restrict__ cost,
                                  float* __restrict__ dQ, float* __restrict__ xhist, int K,
                                  int ks, int H, float max_cost, float ct, GPArgs gp,
                                  ValueArgs v) {
  gp_grad_cost_rollout_body<Cost, L, true>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct,
                                           gp, &v);
}

// K10's value_spec form's dynamic shared memory for M inducing points and
// the value net of v at kGpLanes lanes a rollout, or -1 where it refuses
// either.
inline long gp_value_smem_bytes(int M, const ValueArgs& v) {
  using Cost = CartpoleCost;
  const long gp_bytes = gp_smem_bytes<Cost::S, Cost::U>(M);
  if (gp_bytes < 0 || !value_net_ok(v, Cost::S)) return -1;
  const long bytes = gp_bytes + static_cast<long>(value_smem_bytes(v, kGpThreads / kGpLanes));
  return bytes <= kMaxSmem ? bytes : -1;
}

long gp_value_allowed = 0;  // the value_spec form's shared memory allowed so far

// Size the shared memory, allow it and launch `kernel` over K rollouts,
// `lanes` threads a rollout and `threads` a block.
template <class Kernel, class... Args>
int launch_gp(Kernel kernel, long& allowed, const GPArgs& gp, int K, int lanes, int threads,
              void* stream, Args... args) {
  using Cost = CartpoleCost;
  const long bytes = gp_smem_bytes<Cost::S, Cost::U>(gp.M);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((static_cast<long>(K) * lanes + threads - 1) / threads);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(args..., gp);
  return static_cast<int>(cudaGetLastError());
}

constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// The dynamic shared memory allowed so far to K14 ([0]) and K10 ([1]) with
// L lanes a rollout, at [log2 L]; K14's emit_terminal form's.
long gp_allowed[2][6] = {}, gp_emit_allowed[6] = {};

// K14 (grad false) or K10 (grad true) with L lanes a rollout.
template <bool Grad, int L>
auto gp_kernel() {
  if constexpr (Grad) {
    return gp_grad_cost_rollout_kernel<CartpoleCost, L>;
  } else {
    return gp_cost_rollout_kernel<CartpoleCost, L>;
  }
}

// Launch K14 with L lanes a rollout, or its emit_terminal form where
// x_term is not null.
template <int L>
int launch_k14(const void* s0, const void* Q, const void* pvec, void* cost, void* x_term, int K,
               int ks, int H, float max_cost, const GPArgs& gp, void* stream) {
  if (x_term != nullptr) {
    return launch_gp(gp_cost_rollout_emit_kernel<CartpoleCost, L>, gp_emit_allowed[ilog2(L)], gp,
                     K, L, kGpThreads, stream, static_cast<const float*>(s0),
                     static_cast<const float*>(Q), static_cast<const float*>(pvec),
                     static_cast<float*>(cost), static_cast<float*>(x_term), K, ks, H, max_cost);
  }
  return launch_gp(gp_kernel<false, L>(), gp_allowed[0][ilog2(L)], gp, K, L, kGpThreads, stream,
                   static_cast<const float*>(s0), static_cast<const float*>(Q),
                   static_cast<const float*>(pvec), static_cast<float*>(cost), K, ks, H,
                   max_cost);
}

// Launch K10 with L lanes a rollout.
template <int L>
int launch_k10(const void* s0, const void* Q, const void* pvec, void* cost, void* dQ,
               void* xhist, int K, int ks, int H, float max_cost, float ct, const GPArgs& gp,
               void* stream) {
  return launch_gp(gp_kernel<true, L>(), gp_allowed[1][ilog2(L)], gp, K, L, kGpThreads, stream,
                   static_cast<const float*>(s0), static_cast<const float*>(Q),
                   static_cast<const float*>(pvec), static_cast<float*>(cost),
                   static_cast<float*>(dQ), static_cast<float*>(xhist), K, ks, H, max_cost, ct);
}

// Blocks of K14 or K10 with L lanes a rollout that one SM holds for M
// inducing points (0 where M is refused).
template <bool Grad, int L>
int gp_blocks_per_sm(int M) {
  auto kernel = gp_kernel<Grad, L>();
  const long bytes = gp_smem_bytes<CartpoleCost::S, CartpoleCost::U>(M);
  int blocks = 0;
  if (bytes < 0 || allow_smem(kernel, bytes, gp_allowed[Grad][ilog2(L)]) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kGpThreads, bytes) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}

}  // namespace ctt

// Dynamic shared memory (bytes) a GP kernel's block takes for M inducing
// points on a plant of S states and U controls, or -1 where it refuses M.
extern "C" long ctt_gp_smem_bytes(int S, int U, int M) {
  if (S != ctt::CartpoleCost::S || U != ctt::CartpoleCost::U) return -1;
  return ctt::gp_smem_bytes<ctt::CartpoleCost::S, ctt::CartpoleCost::U>(M);
}

// Launches K14 on `stream` over K rollouts, sessions of ks (pvec holds
// K / ks rows, rollout k reading row k / ks: ks = K for one session, the
// session-row form for a fleet), with `lanes` lanes a rollout (1, 2, 4, 8
// or 16; 0 for kGpCostLanes), or, with x_term not null, its emit_terminal
// form, which also writes the terminal states [K, S] there; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown plant, another `lanes`, a ks that does not divide K, or an M
// whose inducing points exceed a block's shared memory.
extern "C" int ctt_gp_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                   void* cost, void* x_term, int K, int ks, int H,
                                   float max_cost, int lanes, const ctt::GPArgs* gp,
                                   void* stream) {
  using ctt::launch_k14;
  if (plant != ctt::kPlantCartpole || ks < 1 || K % ks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (lanes == 0 ? ctt::kGpCostLanes : lanes) {
    case 1: return launch_k14<1>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, *gp, stream);
    case 2: return launch_k14<2>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, *gp, stream);
    case 4: return launch_k14<4>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, *gp, stream);
    case 8: return launch_k14<8>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, *gp, stream);
    case 16: return launch_k14<16>(s0, Q, pvec, cost, x_term, K, ks, H, max_cost, *gp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K10 on `stream` over K rollouts, sessions of ks as K14's, with
// `lanes` lanes a rollout (4, 8, 16 or 32; 0 for kGpLanes), or, with v not
// null, its value_spec form (V of the net of *v added at x_H; kGpLanes
// lanes only); returns as above.  xhist is scratch of H*S*K floats that
// the caller allocates.
extern "C" int ctt_gp_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                        const void* pvec, void* cost, void* dQ, void* xhist,
                                        int K, int ks, int H, float max_cost, float ct,
                                        int lanes, const ctt::GPArgs* gp,
                                        const ctt::ValueArgs* v, void* stream) {
  using ctt::launch_k10;
  if (plant != ctt::kPlantCartpole || ks < 1 || K % ks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v != nullptr) {
    constexpr int L = ctt::kGpLanes;
    const long bytes = ctt::gp_value_smem_bytes(gp->M, *v);
    if ((lanes != 0 && lanes != L) || bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = ctt::gp_grad_cost_rollout_value_kernel<ctt::CartpoleCost, L>;
    const cudaError_t err = ctt::allow_smem(kernel, bytes, ctt::gp_value_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((static_cast<long>(K) * L + ctt::kGpThreads - 1) / ctt::kGpThreads);
    kernel<<<grid, ctt::kGpThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s0), static_cast<const float*>(Q),
        static_cast<const float*>(pvec), static_cast<float*>(cost), static_cast<float*>(dQ),
        static_cast<float*>(xhist), K, ks, H, max_cost, ct, *gp, *v);
    return static_cast<int>(cudaGetLastError());
  }
  switch (lanes == 0 ? ctt::kGpLanes : lanes) {
    case 4:
      return launch_k10<4>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct, *gp, stream);
    case 8:
      return launch_k10<8>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct, *gp, stream);
    case 16:
      return launch_k10<16>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct, *gp, stream);
    case 32:
      return launch_k10<32>(s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct, *gp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layout of K14 (grad 0) or K10 (grad 1) for M inducing points with
// `lanes` lanes a rollout (0 for the kernel's own): returns the lanes it
// takes, and in *block_threads and *blocks_per_sm its threads a block and
// the blocks one SM holds; 0 (and zeros) for a refused M or `lanes`.
extern "C" int ctt_gp_layout(int grad, int M, int lanes, int* block_threads,
                             int* blocks_per_sm) {
  using ctt::gp_blocks_per_sm;
  const int L = lanes != 0 ? lanes : grad ? ctt::kGpLanes : ctt::kGpCostLanes;
  int blocks = 0;
  if (grad) {
    switch (L) {
      case 4: blocks = gp_blocks_per_sm<true, 4>(M); break;
      case 8: blocks = gp_blocks_per_sm<true, 8>(M); break;
      case 16: blocks = gp_blocks_per_sm<true, 16>(M); break;
      case 32: blocks = gp_blocks_per_sm<true, 32>(M); break;
      default: break;
    }
  } else {
    switch (L) {
      case 1: blocks = gp_blocks_per_sm<false, 1>(M); break;
      case 2: blocks = gp_blocks_per_sm<false, 2>(M); break;
      case 4: blocks = gp_blocks_per_sm<false, 4>(M); break;
      case 8: blocks = gp_blocks_per_sm<false, 8>(M); break;
      case 16: blocks = gp_blocks_per_sm<false, 16>(M); break;
      default: break;
    }
  }
  *block_threads = blocks > 0 ? ctt::kGpThreads : 0;
  *blocks_per_sm = blocks;
  return blocks > 0 ? L : 0;
}

// K10's value_spec form's dynamic shared memory for M inducing points and
// the value net of v into *bytes (-1 where it refuses either); returns the
// blocks an SM holds (0 where refused).
extern "C" int ctt_gp_grad_value_layout(int M, const ctt::ValueArgs* v, long* bytes) {
  *bytes = ctt::gp_value_smem_bytes(M, *v);
  auto kernel = ctt::gp_grad_cost_rollout_value_kernel<ctt::CartpoleCost, ctt::kGpLanes>;
  int blocks = 0;
  if (*bytes < 0 || ctt::allow_smem(kernel, *bytes, ctt::gp_value_allowed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, ctt::kGpThreads, *bytes) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}
