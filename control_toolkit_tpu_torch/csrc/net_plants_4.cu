// K11 (plain, emit_terminal, member-block and member-block emit_terminal) and K13 (GRU and LSTM,
// each plain and emit_terminal) over the 3-D quadrotor's cost (nets of (S, U) = (12, 4): two lane
// tiles each way): net_rollout.cuh's bodies, the network forms' cost group 4 (net_group), compiled
// in a source of their own so that no source's build grows.  Their session-row forms are the same
// instances at ks < K.  The C entries that dispatch to them are neural_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:build_neural_cost_rollout_kernel and
// build_recurrent_cost_rollout_kernel over those costs.
#include "net_rollout.cuh"

namespace ctt {

int net_plants_4(const NetCall& c) { return net_call_in<kPlantQuadrotor3D>(c); }

}  // namespace ctt
