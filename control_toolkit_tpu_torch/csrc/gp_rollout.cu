// K14 and K10 under sparse-GP dynamics: the C entries.  The kernels, their
// design and what bounds them on an H100 are in gp_kernels.cuh; the
// instances over cartpole's cost (at every lane count the entries take) are
// this source's, those over the nine other costs (at the kernels' own
// lanes) gp_plants_<group>.cu's (gp_group), which the entries call for
// every plant id but cartpole's.
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_gp_cost_rollout_kernel (K14) and ops/pallas_grad.py:
// build_gp_grad_cost_rollout_kernel (K10).  Python wrappers and plain
// versions: ops/gp_rollout.py and ops/gp_grad_cost_rollout.py.
#include "gp_kernels.cuh"

namespace ctt {

long gp_value_allowed = 0;  // the value_spec form's shared memory allowed so far

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
    return launch_gp<CartpoleCost>(gp_cost_rollout_emit_kernel<CartpoleCost, L>, gp_emit_allowed[ilog2(L)],
                                   gp, K, L, kGpThreads, stream, static_cast<const float*>(s0),
                                   static_cast<const float*>(Q), static_cast<const float*>(pvec),
                                   static_cast<float*>(cost), static_cast<float*>(x_term), K, ks,
                                   H, max_cost);
  }
  return launch_gp<CartpoleCost>(gp_kernel<false, L>(), gp_allowed[0][ilog2(L)], gp, K, L,
                                 kGpThreads, stream, static_cast<const float*>(s0),
                                 static_cast<const float*>(Q), static_cast<const float*>(pvec),
                                 static_cast<float*>(cost), K, ks, H, max_cost);
}

// Launch K10 with L lanes a rollout.
template <int L>
int launch_k10(const void* s0, const void* Q, const void* pvec, void* cost, void* dQ,
               void* xhist, int K, int ks, int H, float max_cost, float ct, const GPArgs& gp,
               void* stream) {
  return launch_gp<CartpoleCost>(gp_kernel<true, L>(), gp_allowed[1][ilog2(L)], gp, K, L,
                                 kGpThreads, stream, static_cast<const float*>(s0),
                                 static_cast<const float*>(Q), static_cast<const float*>(pvec),
                                 static_cast<float*>(cost), static_cast<float*>(dQ),
                                 static_cast<float*>(xhist), K, ks, H, max_cost, ct);
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
// points on a plant of S states and U controls (any of the ten costs'
// widths), or -1 where it refuses M or the widths.
extern "C" long ctt_gp_smem_bytes(int S, int U, int M) {
  long bytes = -1;
  for (int plant = ctt::kPlantCartpole; plant <= ctt::kPlantArm2Fast && bytes < 0; ++plant) {
    ctt::with_net_cost(plant, [&](auto cost_tag) {
      using Cost = decltype(cost_tag);
      if (Cost::S == S && Cost::U == U) bytes = ctt::gp_smem_bytes<Cost::S, Cost::U>(M);
      return 0;
    });
  }
  return bytes;
}

// Launches K14 on `stream` over K rollouts, sessions of ks (pvec holds
// K / ks rows, rollout k reading row k / ks: ks = K for one session, the
// session-row form for a fleet), with `lanes` lanes a rollout (1, 2, 4, 8
// or 16; 0 for kGpCostLanes), or, with x_term not null, its emit_terminal
// form, which also writes the terminal states [K, S] there; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// plant that is no cost's, another `lanes` (over a cost other than
// cartpole's, any but kGpCostLanes), a ks that does not divide K, or an M
// whose inducing points exceed a block's shared memory.  `plant` is the
// cost's (ops/kernels.py PLANT_IDS).
extern "C" int ctt_gp_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                   void* cost, void* x_term, int K, int ks, int H,
                                   float max_cost, int lanes, const ctt::GPArgs* gp,
                                   void* stream) {
  using ctt::launch_k14;
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (plant != ctt::kPlantCartpole) {
    if (lanes != 0 && lanes != ctt::kGpCostLanes) return static_cast<int>(cudaErrorInvalidValue);
    return ctt::gp_plants({plant, 0, 0, s0, Q, pvec, cost, x_term, nullptr, nullptr, K, ks, H,
                           max_cost, 0.0f, gp, nullptr, stream, nullptr});
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
// `lanes` lanes a rollout (4, 8, 16 or 32; 0 for kGpLanes; over a cost
// other than cartpole's kGpLanes only), or, with v not null, its value_spec
// form (V of the net of *v added at x_H; kGpLanes lanes only); returns as
// above.  xhist is scratch of H*S*K floats that
// the caller allocates.
extern "C" int ctt_gp_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                        const void* pvec, void* cost, void* dQ, void* xhist,
                                        int K, int ks, int H, float max_cost, float ct,
                                        int lanes, const ctt::GPArgs* gp,
                                        const ctt::ValueArgs* v, void* stream) {
  using ctt::launch_k10;
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (plant != ctt::kPlantCartpole || v != nullptr) {
    if (lanes != 0 && lanes != ctt::kGpLanes) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (plant != ctt::kPlantCartpole) {
    return ctt::gp_plants({plant, 1, 0, s0, Q, pvec, cost, nullptr, dQ, xhist, K, ks, H,
                           max_cost, ct, gp, v, stream, nullptr});
  }
  if (v != nullptr) {
    return ctt::launch_k10_value<ctt::CartpoleCost>(ctt::gp_value_allowed, s0, Q, pvec, cost, dQ,
                                                    xhist, K, ks, H, max_cost, ct, *gp, *v,
                                                    stream);
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

// The layout of K14 (grad 0) or K10 (grad 1) over the cost of plant id
// `plant` for M inducing points with `lanes` lanes a rollout (0 for the
// kernel's own; over a cost other than cartpole's, the kernel's own only):
// returns the lanes it takes, and in *block_threads and *blocks_per_sm its
// threads a block and the blocks one SM holds; 0 (and zeros) for a refused
// M, `lanes` or plant.
extern "C" int ctt_gp_layout(int plant, int grad, int M, int lanes, int* block_threads,
                             int* blocks_per_sm) {
  using ctt::gp_blocks_per_sm;
  const int own = grad ? ctt::kGpLanes : ctt::kGpCostLanes;
  const int L = lanes != 0 ? lanes : own;
  int blocks = 0;
  if (plant != ctt::kPlantCartpole) {
    if (L == own) {
      const ctt::GPArgs gp{M};
      blocks = ctt::gp_plants({plant, grad, 1, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, 0, 0, 0, 0.0f, 0.0f, &gp, nullptr, nullptr,
                               nullptr});
    }
  } else if (grad) {
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

// K10's value_spec form's dynamic shared memory over the cost of plant id
// `plant` for M inducing points and the value net of v into *bytes (-1
// where it refuses either, or the plant); returns the blocks an SM holds (0
// where refused).
extern "C" int ctt_gp_grad_value_layout(int plant, int M, const ctt::ValueArgs* v,
                                        long* bytes) {
  if (plant != ctt::kPlantCartpole) {
    const ctt::GPArgs gp{M};
    return ctt::gp_plants({plant, 1, 1, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, 0, 0, 0, 0.0f, 0.0f, &gp, v, nullptr, bytes});
  }
  *bytes = ctt::gp_value_smem_bytes<ctt::CartpoleCost>(M, *v);
  auto kernel = ctt::gp_grad_cost_rollout_value_kernel<ctt::CartpoleCost, ctt::kGpLanes>;
  int blocks = 0;
  if (*bytes < 0 || ctt::allow_smem(kernel, *bytes, ctt::gp_value_allowed) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, ctt::kGpThreads, *bytes) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}

// The group of gp_plants_<group>.cu that holds the instances over the cost
// of plant id `plant` (-1: none, cartpole's are this source's).
extern "C" int ctt_gp_group(int plant) { return ctt::gp_group(plant); }
