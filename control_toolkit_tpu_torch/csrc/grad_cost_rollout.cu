// K7: rollout cost J and its gradient dJ/dQ over K control sequences, as a
// forward launch and a time-parallel adjoint launch: the C entries.  The
// kernels, their design and what bounds them are in grad_core.cuh; the
// value_spec instances over the plants other than cartpole's in
// grad_value_plants_<group>.cu.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_grad_cost_rollout_kernel.
// Python wrapper and plain version: ops/grad_cost_rollout.py.
#include "grad_core.cuh"

// Launch K7's forward on `stream` over K rollouts, sessions of ks (pvec
// holds K / ks rows, rollout k reading row k / ks: ks = K for one session,
// the session-row form for a fleet); returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unknown plant or a ks that does not
// divide K).  xhist is scratch of (H+1)*S*K floats that the caller
// allocates.
extern "C" int ctt_grad_cost_forward(int plant, const void* s0, const void* Q, const void* pvec,
                                     void* cost, void* xhist, int K, int ks, int H, int rk4,
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
  auto* xf = static_cast<float*>(xhist);
  return ctt::with_ode_plant(plant, [&](auto plant_tag) {
    return ctt::launch_grad_forward<decltype(plant_tag)>(grid, st, s0f, qf, pf, costf, xf, K, ks,
                                                         H, c, max_cost);
  });
}

// The forward value instance's dynamic shared memory for the net of v, or
// -1 where the kernel refuses the net (a layer count outside
// 1..kMaxValueLayers, an input width other than S, an output width other
// than 1, or more than a block's shared memory).
extern "C" long ctt_value_smem_bytes(const ctt::ValueArgs* v, int S) {
  if (!ctt::value_net_ok(*v, S)) return -1;
  const size_t bytes = ctt::value_smem_bytes(*v, ctt::kThreads);
  return bytes > ctt::kMaxSmemBytes ? -1 : static_cast<long>(bytes);
}

// Launch K7's forward value_spec instance on `stream` over K rollouts,
// sessions of ks as ctt_grad_cost_forward's (ks = K: one session, else its
// session-row form, every session under V): the forward's outputs and
// vgrad [S, K] = ct * dV/dx_H of the net of v; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown plant, a ks that
// does not divide K or a net that ctt_value_smem_bytes refuses).
extern "C" int ctt_grad_cost_forward_value(int plant, const void* s0, const void* Q,
                                           const void* pvec, void* cost, void* xhist,
                                           void* vgrad, int K, int ks, int H, int rk4,
                                           int substeps, float sub_dt, float half_dt, float dt6,
                                           float max_cost, float ct, const ctt::ValueArgs* v,
                                           void* stream) {
  int S, U;
  if (ks < 1 || K % ks != 0 || !ctt::plant_dims(plant, S, U)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const long bytes = ctt_value_smem_bytes(v, S);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s0f = static_cast<const float*>(s0);
  const auto* qf = static_cast<const float*>(Q);
  const auto* pf = static_cast<const float*>(pvec);
  auto* costf = static_cast<float*>(cost);
  auto* xf = static_cast<float*>(xhist);
  auto* vf = static_cast<float*>(vgrad);
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_grad_forward_value<ctt::CartpolePlant>(
          grid, st, bytes, s0f, qf, pf, costf, xf, vf, K, ks, H, c, max_cost, ct, *v);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_grad_forward_value<ctt::CartpoleFastPlant>(
          grid, st, bytes, s0f, qf, pf, costf, xf, vf, K, ks, H, c, max_cost, ct, *v);
    default:
      if (ctt::grad_value_group(plant) == 0) {
        return ctt::launch_grad_forward_value_group<0>(plant, grid, st, bytes, s0f, qf, pf, costf,
                                                       xf, vf, K, ks, H, c, max_cost, ct, *v);
      }
      return ctt::launch_grad_forward_value_group<1>(plant, grid, st, bytes, s0f, qf, pf, costf,
                                                     xf, vf, K, ks, H, c, max_cost, ct, *v);
  }
}

// Launch K7's adjoint on `stream` over the forward's xhist, sessions of ks
// as the forward's, or, with vgrad not null, its value_spec instance
// (its session-row form where ks < K), which adds vgrad [S, K] to lam_H;
// returns as above.
extern "C" int ctt_grad_cost_adjoint(int plant, const void* Q, const void* pvec,
                                     const void* xhist, const void* vgrad, void* dQ, int K,
                                     int ks, int H, int rk4, int substeps, float sub_dt,
                                     float half_dt, float dt6, float ct, void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kAdjRollouts - 1) / ctt::kAdjRollouts);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(Q);
  const auto* pf = static_cast<const float*>(pvec);
  const auto* xf = static_cast<const float*>(xhist);
  const auto* vf = static_cast<const float*>(vgrad);
  auto* dqf = static_cast<float*>(dQ);
  if (vf == nullptr) {
    return ctt::with_ode_plant(plant, [&](auto plant_tag) {
      return ctt::launch_grad_adjoint<decltype(plant_tag)>(grid, st, qf, pf, xf, dqf, K, ks, H, c,
                                                           ct);
    });
  }
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_grad_adjoint_value<ctt::CartpolePlant>(grid, st, qf, pf, xf, vf, dqf, K,
                                                                ks, H, c, ct);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_grad_adjoint_value<ctt::CartpoleFastPlant>(grid, st, qf, pf, xf, vf, dqf,
                                                                    K, ks, H, c, ct);
    default:
      if (ctt::grad_value_group(plant) == 0) {
        return ctt::launch_grad_adjoint_value_group<0>(plant, grid, st, qf, pf, xf, vf, dqf, K, ks,
                                                       H, c, ct);
      }
      return ctt::launch_grad_adjoint_value_group<1>(plant, grid, st, qf, pf, xf, vf, dqf, K, ks,
                                                     H, c, ct);
  }
}

// Blocks of K7's single-session forward (adjoint 0) or adjoint (1) over
// `plant` that one SM holds (0 where the runtime cannot say or the plant
// has no instance).
extern "C" int ctt_grad_cost_plant_blocks_per_sm(int plant, int adjoint) {
  if (plant == ctt::kPlantCartpole) return ctt::grad_blocks_per_sm<ctt::CartpolePlant>(adjoint);
  if (plant == ctt::kPlantCartpoleFast) {
    return ctt::grad_blocks_per_sm<ctt::CartpoleFastPlant>(adjoint);
  }
  if (!ctt::is_slice_plant(plant)) return 0;
  return ctt::with_slice_plant(plant, [&](auto plant_tag) {
    return ctt::grad_blocks_per_sm<decltype(plant_tag)>(adjoint);
  });
}

// Blocks of K7's session-row forward (adjoint 0) or adjoint (1) over
// `plant` that one SM holds (0 where the runtime cannot say or the plant is
// unknown).
extern "C" int ctt_grad_cost_rows_plant_blocks_per_sm(int plant, int adjoint) {
  int blocks = 0;
  const int rc = ctt::with_ode_plant(plant, [&](auto plant_tag) {
    blocks = ctt::grad_blocks_per_sm<decltype(plant_tag), true>(adjoint);
    return 0;
  });
  return rc == 0 ? blocks : 0;
}

// Blocks of K7's forward kernel (rows 0) or of its session-row form (rows
// 1) that one SM holds (0 where the runtime cannot say).
extern "C" int ctt_grad_cost_forward_blocks_per_sm(int rows) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks,
          rows ? ctt::grad_cost_forward_kernel<ctt::CartpolePlant, true>
               : ctt::grad_cost_forward_kernel<ctt::CartpolePlant, false>,
          ctt::kThreads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// Blocks of K7's adjoint kernel (rows 0) or of its session-row form (rows
// 1) that one SM holds (0 where the runtime cannot say).
extern "C" int ctt_grad_cost_adjoint_blocks_per_sm(int rows) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks,
          rows ? ctt::grad_cost_adjoint_kernel<ctt::CartpolePlant, true>
               : ctt::grad_cost_adjoint_kernel<ctt::CartpolePlant, false>,
          ctt::kAdjThreads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// Blocks of K7's value_spec forward (adjoint 0; its dynamic shared memory
// for the net of v) or adjoint (1) over `plant` that one SM holds, one
// session's (rows 0) or the session-row form's (rows 1); 0 where the
// runtime cannot say, the plant is unknown or the net is refused.
extern "C" int ctt_grad_value_plant_blocks_per_sm(int plant, int adjoint, int rows,
                                                  const ctt::ValueArgs* v) {
  int S, U;
  const long bytes = ctt::plant_dims(plant, S, U) ? ctt_value_smem_bytes(v, S) : -1;
  if (bytes < 0) return 0;
  if (plant == ctt::kPlantCartpole) {
    return ctt::grad_value_blocks_per_sm<ctt::CartpolePlant>(adjoint, rows, bytes);
  }
  if (plant == ctt::kPlantCartpoleFast) {
    return ctt::grad_value_blocks_per_sm<ctt::CartpoleFastPlant>(adjoint, rows, bytes);
  }
  switch (ctt::grad_value_group(plant)) {
    case 0: return ctt::grad_value_group_blocks_per_sm<0>(plant, adjoint, rows, bytes);
    case 1: return ctt::grad_value_group_blocks_per_sm<1>(plant, adjoint, rows, bytes);
    default: return 0;
  }
}

// The source that holds the value forms' instances over `plant`:
// grad_value_plants_<group>.cu (-1: none, cartpole's are this source's).
extern "C" int ctt_grad_value_group(int plant) { return ctt::grad_value_group(plant); }
