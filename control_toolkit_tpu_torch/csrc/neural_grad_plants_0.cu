// K8 (plain, value_spec, member-block and member-block value_spec) over the pendulum's and the
// planar quadrotor's costs (nets of (S, U) = (2, 1) and (6, 2)): neural_grad_core.cuh's body, the
// network forms' cost group 0 (net_group), compiled in a source of its own so that no source's
// build grows; the MLP's step and VJP are outlined calls, one body each for the group's widths.
// The session-row forms are the same instances at ks < K.  The C entries that dispatch to them are
// neural_grad_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_neural_grad_cost_rollout_kernel over those
// costs.
#include "neural_grad_core.cuh"

namespace ctt {

int neural_grad_plants_0(const GradCall& c) {
  return neural_grad_call_in<kPlantPendulum, kPlantQuadrotor2D>(c);
}

}  // namespace ctt
