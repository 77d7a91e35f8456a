// K12 and K9 under the residual "ODE+res" model: the C entries.  The
// kernels, their design and what bounds them are in residual_core.cuh; the
// instances over the bases other than cartpole's in residual_cost_plants.cu
// and residual_grad_plants_<group>.cu.
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_residual_cost_rollout_kernel (K12) and ops/pallas_grad.py:
// build_residual_grad_cost_rollout_kernel (K9).  Python wrappers and plain
// versions: ops/residual_rollout.py and ops/residual_grad_cost_rollout.py.
#include "residual_core.cuh"

// K12's layout over the base plant of id `plant` for `net`: the block's
// dynamic shared memory in bytes (-1 for a refused net or an unknown
// plant), and in *groups the groups a block.
extern "C" long ctt_residual_plan(int plant, const ctt::NetArgs* net, int* groups) {
  int S, U;
  ctt::ResidualLayout R;
  const long bytes = ctt::plant_dims(plant, S, U) ? ctt::plan_residual(*net, S, U, R) : -1;
  *groups = bytes < 0 ? 0 : R.mlp.groups;
  return bytes;
}

// Launches K12 on `stream` over K rollouts, sessions of ks (pvec holds
// K / ks rows, rollout k reading row k / ks: ks = K for one session, the
// session-row form for a fleet whose rows also carry each session's base
// constants), or, with x_term not null, its emit_terminal form, which also
// writes the terminal states [K, S] there; returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unknown plant, a ks
// that does not divide K or a net the kernel refuses (not an MLP in
// absolute form without norms, or too large for shared memory).
extern "C" int ctt_residual_cost_rollout(int plant, const void* s0, const void* Q,
                                         const void* pvec, void* cost, void* x_term, int K,
                                         int ks, int H, int rk4, int substeps, float sub_dt,
                                         float half_dt, float dt6, float max_cost,
                                         const ctt::NetArgs* net, void* stream) {
  int S, U;
  ctt::ResidualLayout R;
  const long bytes = ctt::plant_dims(plant, S, U) && ks >= 1 && K % ks == 0
                         ? ctt::plan_residual(*net, S, U, R)
                         : -1;
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_residual_cost<ctt::CartpolePlant>(bytes, R, s0, Q, pvec, cost, x_term, K,
                                                           ks, H, c, max_cost, *net, stream);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_residual_cost<ctt::CartpoleFastPlant>(bytes, R, s0, Q, pvec, cost,
                                                               x_term, K, ks, H, c, max_cost,
                                                               *net, stream);
    default:
      return ctt::launch_residual_cost_slice(plant, bytes, R, s0, Q, pvec, cost, x_term, K, ks, H,
                                             c, max_cost, *net, stream);
  }
}

// Blocks of K12 over cartpole that one SM holds for `net` (0 for a refused
// net).
extern "C" int ctt_residual_blocks_per_sm(const ctt::NetArgs* net) {
  return ctt::residual_blocks_per_sm<ctt::CartpolePlant>(false, *net);
}

// Blocks of K12 (emit 0) or of its emit_terminal form (emit 1) over the
// base plant of id `plant` that one SM holds for `net` (0 for a refused net
// or an unknown plant).
extern "C" int ctt_residual_plant_blocks_per_sm(int plant, int emit, const ctt::NetArgs* net) {
  if (plant == ctt::kPlantCartpole) {
    return ctt::residual_blocks_per_sm<ctt::CartpolePlant>(emit, *net);
  }
  if (plant == ctt::kPlantCartpoleFast) {
    return ctt::residual_blocks_per_sm<ctt::CartpoleFastPlant>(emit, *net);
  }
  return ctt::residual_slice_blocks_per_sm(plant, emit, *net);
}

// Launches K9 on `stream` over K rollouts, sessions of ks as K12's, or,
// with v not null, its value_spec form (V of the net of *v added at x_H);
// returns as above.  xhist is scratch of H*S*K floats that the caller
// allocates.
extern "C" int ctt_residual_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                              const void* pvec, void* cost, void* dQ,
                                              void* xhist, int K, int ks, int H, int rk4,
                                              int substeps, float sub_dt, float half_dt,
                                              float dt6, float max_cost, float ct,
                                              const ctt::NetArgs* net, const ctt::ValueArgs* v,
                                              void* stream) {
  if (ks < 1 || K % ks != 0 || !ctt::residual_net(*net)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_residual_grad<ctt::CartpolePlant>(s0, Q, pvec, cost, dQ, xhist, K, ks, H,
                                                           c, max_cost, ct, *net, v, stream);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_residual_grad<ctt::CartpoleFastPlant>(s0, Q, pvec, cost, dQ, xhist, K, ks,
                                                               H, c, max_cost, ct, *net, v,
                                                               stream);
    default:
      return ctt::with_residual_grad_group(plant, [&](auto group) {
        return ctt::launch_residual_grad_group<decltype(group)::value>(
            plant, s0, Q, pvec, cost, dQ, xhist, K, ks, H, c, max_cost, ct, *net, v, stream);
      });
  }
}

// Blocks of K9 over cartpole an SM holds for `net` (0 for a net it refuses).
extern "C" int ctt_residual_grad_blocks_per_sm(const ctt::NetArgs* net) {
  long bytes;
  return ctt::residual_grad_layout<ctt::CartpolePlant>(*net, bytes);
}

// K9's value_spec form over cartpole: its dynamic shared memory for `net`
// and the value net of v into *bytes (-1 for a net either refuses);
// returns the blocks an SM holds (0 for a refused net).
extern "C" int ctt_residual_grad_value_layout(const ctt::NetArgs* net, const ctt::ValueArgs* v,
                                              long* bytes) {
  return ctt::residual_grad_value_layout<ctt::CartpolePlant>(*net, *v, *bytes);
}

// K9 (v null) or its value_spec form over the base plant of id `plant`:
// its dynamic shared memory into *bytes (-1 for a refused net or an unknown
// plant); returns the blocks an SM holds (0 where refused).
extern "C" int ctt_residual_grad_plant_layout(int plant, const ctt::NetArgs* net,
                                              const ctt::ValueArgs* v, long* bytes) {
  *bytes = -1;
  auto layout = [&](auto plant_tag) {
    using Plant = decltype(plant_tag);
    return v ? ctt::residual_grad_value_layout<Plant>(*net, *v, *bytes)
             : ctt::residual_grad_layout<Plant>(*net, *bytes);
  };
  if (plant == ctt::kPlantCartpole) return layout(ctt::CartpolePlant{});
  if (plant == ctt::kPlantCartpoleFast) return layout(ctt::CartpoleFastPlant{});
  if (ctt::residual_grad_group(plant) < 0) return 0;
  return ctt::with_residual_grad_group(plant, [&](auto group) {
    return ctt::residual_grad_group_layout<decltype(group)::value>(plant, *net, v, *bytes);
  });
}

// The source that holds K9's instances over `plant`:
// residual_grad_plants_<group>.cu (-1: none, cartpole's are this source's).
extern "C" int ctt_residual_grad_group(int plant) { return ctt::residual_grad_group(plant); }
