// K14 (plain and emit_terminal, kGpCostLanes lanes a rollout) and K10 (plain and value_spec,
// kGpLanes) over pointmass/obstacles' and the car's two costs: gp_kernels.cuh's bodies, the GP
// kernels' cost group 1 (gp_group), compiled in a source of their own so that no source's build
// grows.  Their session-row forms are the same instances at ks < K.  The C entries that dispatch to
// them are gp_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:build_gp_cost_rollout_kernel and
// ops/pallas_grad.py:build_gp_grad_cost_rollout_kernel over those costs.
#include "gp_kernels.cuh"

namespace ctt {

int gp_plants_1(const GpCall& c) {
  return gp_call_in<kPlantPointmassObstacles, kPlantCar, kPlantCarObstacles>(c);
}

}  // namespace ctt
