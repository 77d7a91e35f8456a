// K8 (plain, value_spec, member-block and member-block value_spec) over the 3-D quadrotor's cost
// (nets of (S, U) = (12, 4): two lane tiles each way): neural_grad_core.cuh's body, the network
// forms' cost group 4 (net_group), compiled in a source of its own so that no source's build grows;
// the MLP's step and VJP are outlined calls, one body each for the group's widths.  The session-row
// forms are the same instances at ks < K.  The C entries that dispatch to them are
// neural_grad_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_neural_grad_cost_rollout_kernel over those
// costs.
#include "neural_grad_core.cuh"

namespace ctt {

int neural_grad_plants_4(const GradCall& c) { return neural_grad_call_in<kPlantQuadrotor3D>(c); }

}  // namespace ctt
