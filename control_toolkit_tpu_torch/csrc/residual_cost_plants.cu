// K12 and its emit_terminal form (one session and the session-row form)
// over the pendulum, acrobot, point-mass, quadrotor, car and arm bases and
// their fast plants: residual_core.cuh's bodies, in a source of their own
// so that no source's build grows.  The C entries that dispatch to them are
// residual_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:build_residual_cost_rollout_kernel
// over those bases (models/residual_predictor.py takes any environment).
#include "residual_core.cuh"

namespace ctt {

int launch_residual_cost_slice(int plant, long bytes, const ResidualLayout& R, const void* s0,
                               const void* Q, const void* pvec, void* cost, void* x_term, int K,
                               int ks, int H, const StepConsts& c, float max_cost,
                               const NetArgs& net, void* stream) {
  return with_slice_plant(plant, [&](auto plant_tag) {
    return launch_residual_cost<decltype(plant_tag)>(bytes, R, s0, Q, pvec, cost, x_term, K, ks,
                                                     H, c, max_cost, net, stream);
  });
}

int residual_slice_blocks_per_sm(int plant, bool emit, const NetArgs& net) {
  if (!is_slice_plant(plant)) return 0;
  return with_slice_plant(plant, [&](auto plant_tag) {
    return residual_blocks_per_sm<decltype(plant_tag)>(emit, net);
  });
}

}  // namespace ctt
