// K9 and its value_spec form (one session and the session-row form) over the 3-D quadrotor bases
// ((S, U) = (12, 4): two lane tiles each way): residual_core.cuh's body, K9's plant group 4
// (residual_grad_group), in a source of its own so that no source's build grows.  The C entries
// that dispatch to it are residual_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_residual_grad_cost_rollout_kernel
// over those bases.
#include "residual_core.cuh"

namespace ctt {

template <>
int launch_residual_grad_group<4>(int plant, const void* s0, const void* Q, const void* pvec,
                                  void* cost, void* dQ, void* xhist, int K, int ks, int H,
                                  const StepConsts& c, float max_cost, float ct,
                                  const NetArgs& net, const ValueArgs* v, void* stream) {
  return launch_residual_grad_in<kPlantQuadrotor3D, kPlantQuadrotor3DFast>(
      plant, s0, Q, pvec, cost, dQ, xhist, K, ks, H, c, max_cost, ct, net, v, stream);
}

template <>
int residual_grad_group_layout<4>(int plant, const NetArgs& net, const ValueArgs* v,
                                  long& bytes) {
  return residual_grad_layout_in<kPlantQuadrotor3D, kPlantQuadrotor3DFast>(plant, net, v, bytes);
}

}  // namespace ctt
