// K8's C entries and its instances over cartpole's cost: neural_grad_core.cuh's
// bodies (the kernel's note is there), the MLP's step and VJP inlined
// (kInlineNet).  The instances over the nine other costs are
// neural_grad_plants_<group>.cu's, by net_group; these entries dispatch to
// them by the cost's plant id.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:
// build_neural_grad_cost_rollout_kernel.  Python wrapper and plain version:
// ops/neural_grad_cost_rollout.py.
#include "neural_grad_core.cuh"

namespace {

// K8's call `c` over the cost of c.plant: cartpole's instances here, the
// nine others' in their group's source.
int neural_grad(const ctt::GradCall& c) {
  return c.plant == ctt::kPlantCartpole ? ctt::neural_grad_call<ctt::CartpoleCost>(c)
                                        : ctt::neural_grad_plants(c);
}

// K8's layout query over the cost of `plant`: the blocks one SM holds, the
// bytes into *bytes (one-member blocks for the member-block forms).
int neural_grad_layout(int plant, int members, const ctt::NetArgs* net, const ctt::ValueArgs* v,
                       long* bytes) {
  return neural_grad({plant, members, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                      0, 0.0f, 0.0f, net, v, nullptr, bytes});
}

}  // namespace

// Launches K8 over the cost of plant id `plant` (one of the ten costs:
// cartpole's or net_group's) on `stream` over K rollouts, sessions of ks
// (pvec holds K / ks rows, rollout k reading row k / ks: ks = K for one
// session, the session-row form for a fleet), or, with v not null, its
// value_spec form (V of the net of *v added at x_H, one session or the
// session-row form); returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plant that is no cost's (a fast plant's id
// among them), a ks that does not divide K or a net (or value net) the
// kernel refuses.  xhist is scratch of H*S*K floats that the caller
// allocates.
extern "C" int ctt_neural_grad_cost_rollout(int plant, const void* s0, const void* Q,
                                            const void* pvec, void* cost, void* dQ, void* xhist,
                                            int K, int ks, int H, float max_cost, float ct,
                                            const ctt::NetArgs* net, const ctt::ValueArgs* v,
                                            void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  return neural_grad({plant, 0, s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct, net, v,
                      stream, nullptr});
}

// Launches K8's member-block (n_members) form over the cost of plant id
// `plant` on `stream` over K rollouts under the stacked ensemble `net`
// (member 0's pointers; every tensor with a leading member axis), ks = K /
// E rollouts a member: rollout k under member k / ks; pvec holds one row;
// with v not null, its value_spec form.  Returns as
// ctt_neural_grad_cost_rollout.
extern "C" int ctt_neural_grad_cost_rollout_ens(int plant, const void* s0, const void* Q,
                                                const void* pvec, void* cost, void* dQ,
                                                void* xhist, int K, int ks, int H,
                                                float max_cost, float ct,
                                                const ctt::NetArgs* net,
                                                const ctt::ValueArgs* v, void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  return neural_grad({plant, 1, s0, Q, pvec, cost, dQ, xhist, K, ks, H, max_cost, ct, net, v,
                      stream, nullptr});
}

// Dynamic shared memory (bytes) a block of the gradient kernels K8 and K9
// takes for `net` on the plant of id `plant` (its S states and U controls;
// any of the 18 ids: K9's plant is its base's), or -1 for a net they refuse
// or an unknown id.
extern "C" long ctt_mma_net_smem_bytes(int plant, const ctt::NetArgs* net) {
  long bytes = -1;
  ctt::with_ode_plant(plant, [&](auto plant_tag) {
    using Plant = decltype(plant_tag);
    ctt::MmaLayout L;
    bytes = ctt::plan_mma(*net, Plant::S, Plant::U, L);
    return 0;
  });
  return bytes;
}

// Blocks of K8 over the cost of plant id `plant` that one SM holds for
// `net` (0 for a refused net or a plant that is no cost's).
extern "C" int ctt_neural_grad_blocks_per_sm(int plant, const ctt::NetArgs* net) {
  long bytes = 0;
  return neural_grad_layout(plant, 0, net, nullptr, &bytes);
}

// Blocks of K8's member-block form over the cost of plant id `plant` that
// one SM holds for one member's net of `net` (0 for a refused net or a
// plant that is no cost's).
extern "C" int ctt_neural_grad_ens_blocks_per_sm(int plant, const ctt::NetArgs* net) {
  long bytes = 0;
  return neural_grad_layout(plant, 1, net, nullptr, &bytes);
}

// The value_spec forms' layout over the cost of plant id `plant` for `net`
// and the value net of v: the block's dynamic shared memory in bytes (-1
// for a net either refuses, or a plant that is no cost's) into *bytes, and
// the blocks an SM holds of K8's value form (ens 0) or of its member-block
// form's (ens 1), 0 where refused.
extern "C" int ctt_neural_grad_value_layout(int plant, const ctt::NetArgs* net,
                                            const ctt::ValueArgs* v, int ens, long* bytes) {
  return neural_grad_layout(plant, ens, net, v, bytes);
}
