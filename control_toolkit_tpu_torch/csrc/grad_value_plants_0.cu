// K7's value_spec instances (the forward's and the adjoint's, one session and
// the session-row form) over the pendulum, acrobot, point-mass and planar
// quadrotor plants (ids 2-9): the bodies of grad_core.cuh, the value forms'
// plant group 0 (grad_value_group), compiled in a source of its own so that
// grad_cost_rollout.cu, the slowest source to build, keeps its time.  The C
// entries that dispatch to them are grad_cost_rollout.cu's.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_grad_cost_rollout_kernel
// with value_spec (:119-141, V at :196-197) over the plants' costs.
#include "grad_core.cuh"

namespace ctt {

template <>
int launch_grad_forward_value_group<0>(int plant, dim3 grid, cudaStream_t st, long bytes,
                                       const float* s0, const float* Q, const float* pvec,
                                       float* cost, float* xhist, float* vgrad, int K, int ks,
                                       int H, const StepConsts& c, float max_cost, float ct,
                                       const ValueArgs& v) {
  return launch_grad_forward_value_in<kPlantPendulum, kPlantPendulumFast, kPlantAcrobot,
                                      kPlantAcrobotFast, kPlantPointmass,
                                      kPlantPointmassObstacles, kPlantQuadrotor2D,
                                      kPlantQuadrotor2DFast>(
      plant, grid, st, bytes, s0, Q, pvec, cost, xhist, vgrad, K, ks, H, c, max_cost, ct, v);
}

template <>
int launch_grad_adjoint_value_group<0>(int plant, dim3 grid, cudaStream_t st, const float* Q,
                                       const float* pvec, const float* xhist,
                                       const float* vgrad, float* dQ, int K, int ks, int H,
                                       const StepConsts& c, float ct) {
  return launch_grad_adjoint_value_in<kPlantPendulum, kPlantPendulumFast, kPlantAcrobot,
                                      kPlantAcrobotFast, kPlantPointmass,
                                      kPlantPointmassObstacles, kPlantQuadrotor2D,
                                      kPlantQuadrotor2DFast>(
      plant, grid, st, Q, pvec, xhist, vgrad, dQ, K, ks, H, c, ct);
}

template <>
int grad_value_group_blocks_per_sm<0>(int plant, bool adjoint, bool rows, long bytes) {
  return grad_value_blocks_per_sm_in<kPlantPendulum, kPlantPendulumFast, kPlantAcrobot,
                                     kPlantAcrobotFast, kPlantPointmass, kPlantPointmassObstacles,
                                     kPlantQuadrotor2D, kPlantQuadrotor2DFast>(
      plant, adjoint, rows, bytes);
}

}  // namespace ctt
