// K11 and K13 under a learned network: the C entries.  The kernels, their
// design and what bounds them on an H100 are in net_rollout.cuh; the
// instances over cartpole's cost are this source's, those over the nine
// other costs net_plants_<group>.cu's (net_group), which the entries call
// for every plant id but cartpole's.
//
// Replaces control_toolkit_tpu/ops/pallas_neural.py:
// build_neural_cost_rollout_kernel (K11) and
// build_recurrent_cost_rollout_kernel (K13).  Python wrappers and plain
// versions: ops/neural_rollout.py.
#include "net_rollout.cuh"

extern "C" long ctt_net_smem_bytes(const ctt::NetArgs* net, int S, int U) {
  if (net->kind == ctt::kNetGRU || net->kind == ctt::kNetLSTM) {
    ctt::RnnLayout R;
    return ctt::plan_rnn(*net, S, U, R);
  }
  ctt::MlpUnitsLayout L;
  return ctt::plan_mlp_units(*net, S, U, 0, L);
}

namespace {
// K11's and its member-block form's dynamic shared memory allowed so far,
// and their emit_terminal forms'.
long allowed_mlp = 0, allowed_mlp_ens = 0, allowed_mlp_emit = 0, allowed_mlp_ens_emit = 0;
}  // namespace

// K11's layout for `net` with `warps` warps a group (0: the plan's own):
// the block's dynamic shared memory in bytes (-1 for a refused net), and
// in *group_warps and *groups the warps a group and the groups a block.
extern "C" long ctt_neural_plan(const ctt::NetArgs* net, int S, int U, int warps,
                                int* group_warps, int* groups) {
  ctt::MlpUnitsLayout L;
  const long bytes = ctt::plan_mlp_units(*net, S, U, warps, L);
  *group_warps = bytes < 0 ? 0 : L.warps;
  *groups = bytes < 0 ? 0 : L.groups;
  return bytes;
}

// Launches K11 (an MLP net) on `stream` over K rollouts, sessions of ks
// (pvec holds K / ks rows, rollout k reading row k / ks: ks = K for one
// session, the session-row form for a fleet), with `warps` warps a
// 16-rollout group (1, 2 or 4; 0 for the plan's own), or, with x_term not
// null, its emit_terminal form, which also writes the terminal states
// [K, S] there (one session or sessions of ks alike); returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// plant that is no cost's, another `warps`, a ks that does not divide K or
// a net the kernel refuses.  `plant` is the cost's (ops/kernels.py
// PLANT_IDS: cartpole, the pendulum, acrobot, point masses, quadrotors,
// cars and arm).
extern "C" int ctt_neural_cost_rollout(int plant, const void* s0, const void* Q, const void* pvec,
                                       void* cost, void* x_term, int K, int ks, int H,
                                       float max_cost, int warps, const ctt::NetArgs* net,
                                       void* stream) {
  using Cost = ctt::CartpoleCost;
  if (net->kind != ctt::kNetMLP || ks < 1 || K % ks != 0 ||
      (warps != 0 && warps != 1 && warps != 2 && warps != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (plant != ctt::kPlantCartpole) {
    return ctt::net_plants({plant, ctt::kFormMlp, 0, s0, Q, pvec, cost, x_term, K, ks, H,
                            max_cost, warps, net, stream});
  }
  if (x_term != nullptr) {
    return ctt::launch_mlp_units(ctt::neural_cost_rollout_emit_kernel<Cost>, allowed_mlp_emit,
                                 *net, Cost::S, Cost::U, warps, s0, Q, pvec, cost, K, ks, H,
                                 max_cost, 1, stream, static_cast<float*>(x_term));
  }
  return ctt::launch_mlp_units(ctt::neural_cost_rollout_kernel<Cost>, allowed_mlp, *net, Cost::S,
                               Cost::U, warps, s0, Q, pvec, cost, K, ks, H, max_cost, 1, stream);
}

// Launches K11's member-block (n_members) form on `stream` over K rollouts
// under the stacked ensemble `net` (member 0's pointers; every tensor with
// a leading member axis), ks = K / E rollouts a member: rollout k under
// member k / ks, pvec one row, the plan's warps a group; with x_term not
// null, its emit_terminal form (the terminal states [K, S] there); returns
// as above, or cudaErrorInvalidValue for a ks that does not divide K.
extern "C" int ctt_neural_cost_rollout_ens(int plant, const void* s0, const void* Q,
                                           const void* pvec, void* cost, void* x_term, int K,
                                           int ks, int H, float max_cost,
                                           const ctt::NetArgs* net, void* stream) {
  using Cost = ctt::CartpoleCost;
  if (net->kind != ctt::kNetMLP || ks < 1 || K % ks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (plant != ctt::kPlantCartpole) {
    return ctt::net_plants({plant, ctt::kFormMlpMembers, 0, s0, Q, pvec, cost, x_term, K, ks, H,
                            max_cost, 0, net, stream});
  }
  if (x_term != nullptr) {
    return ctt::launch_mlp_units(ctt::neural_cost_rollout_ens_emit_kernel<Cost>,
                                 allowed_mlp_ens_emit, *net, Cost::S, Cost::U, 0, s0, Q, pvec,
                                 cost, K, ks, H, max_cost, K / ks, stream,
                                 static_cast<float*>(x_term));
  }
  return ctt::launch_mlp_units(ctt::neural_cost_rollout_ens_kernel<Cost>, allowed_mlp_ens, *net,
                               Cost::S, Cost::U, 0, s0, Q, pvec, cost, K, ks, H, max_cost,
                               K / ks, stream);
}

// Blocks of K11 over the cost of plant id `plant` that one SM holds for
// `net` with the plan's warps a group (0 for a refused net or a plant that
// is no cost's).
extern "C" int ctt_neural_blocks_per_sm(int plant, const ctt::NetArgs* net) {
  using Cost = ctt::CartpoleCost;
  if (plant != ctt::kPlantCartpole) {
    return ctt::net_plants({plant, ctt::kFormMlp, 1, nullptr, nullptr, nullptr, nullptr,
                            nullptr, 0, 0, 0, 0.0f, 0, net, nullptr});
  }
  return ctt::mlp_units_blocks_per_sm(ctt::neural_cost_rollout_kernel<Cost>, allowed_mlp, *net,
                                      Cost::S, Cost::U);
}

// Blocks of K11's member-block form over the cost of plant id `plant` that
// one SM holds for one member's net of `net` (0 for a refused net or a
// plant that is no cost's).
extern "C" int ctt_neural_ens_blocks_per_sm(int plant, const ctt::NetArgs* net) {
  using Cost = ctt::CartpoleCost;
  if (plant != ctt::kPlantCartpole) {
    return ctt::net_plants({plant, ctt::kFormMlpMembers, 1, nullptr, nullptr, nullptr, nullptr,
                            nullptr, 0, 0, 0, 0.0f, 0, net, nullptr});
  }
  return ctt::mlp_units_blocks_per_sm(ctt::neural_cost_rollout_ens_kernel<Cost>, allowed_mlp_ens,
                                      *net, Cost::S, Cost::U);
}

namespace {
// K13's dynamic shared memory allowed so far, and its emit_terminal form's.
long allowed_gru = 0, allowed_lstm = 0, allowed_gru_emit = 0, allowed_lstm_emit = 0;

// Launch K13 with G gates a unit, or its emit_terminal form where x_term
// is not null.
template <int G>
int launch_k13(long& allowed, long& allowed_emit, const ctt::NetArgs& net, const void* s0,
               const void* Q, const void* pvec, void* cost, void* x_term, int K, int ks, int H,
               float max_cost, void* stream) {
  using Cost = ctt::CartpoleCost;
  if (x_term != nullptr) {
    return ctt::launch_rnn_kernel(ctt::recurrent_cost_rollout_emit_kernel<Cost, G>, allowed_emit,
                                  net, Cost::S, Cost::U, s0, Q, pvec, cost, K, ks, H, max_cost,
                                  stream, static_cast<float*>(x_term));
  }
  return ctt::launch_rnn_kernel(ctt::recurrent_cost_rollout_kernel<Cost, G>, allowed, net,
                                Cost::S, Cost::U, s0, Q, pvec, cost, K, ks, H, max_cost, stream);
}
}  // namespace

// Launches K13 (a GRU or LSTM net) on `stream` over K rollouts, sessions
// of ks as K11's: rollout k reads pvec's row k / ks and starts from row
// k / ks of each cell's hidden (net->hidden[l], [K / ks, Hd] for the GRU,
// [K / ks, 2 Hd] for the LSTM's [h, c]); with x_term not null, its
// emit_terminal form (the terminal states [K, S] there); returns as above.
extern "C" int ctt_recurrent_cost_rollout(int plant, const void* s0, const void* Q,
                                          const void* pvec, void* cost, void* x_term, int K,
                                          int ks, int H, float max_cost,
                                          const ctt::NetArgs* net, void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (plant != ctt::kPlantCartpole) {
    return ctt::net_plants({plant, ctt::kFormRecurrent, 0, s0, Q, pvec, cost, x_term, K, ks, H,
                            max_cost, 0, net, stream});
  }
  switch (net->kind) {
    case ctt::kNetGRU:
      return launch_k13<3>(allowed_gru, allowed_gru_emit, *net, s0, Q, pvec, cost, x_term, K, ks,
                           H, max_cost, stream);
    case ctt::kNetLSTM:
      return launch_k13<4>(allowed_lstm, allowed_lstm_emit, *net, s0, Q, pvec, cost, x_term, K,
                           ks, H, max_cost, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of K13 over the cost of plant id `plant` that one SM holds for
// `net` (0 for a refused net or a plant that is no cost's).
extern "C" int ctt_recurrent_blocks_per_sm(int plant, const ctt::NetArgs* net) {
  using Cost = ctt::CartpoleCost;
  if (plant != ctt::kPlantCartpole) {
    return ctt::net_plants({plant, ctt::kFormRecurrent, 1, nullptr, nullptr, nullptr, nullptr,
                            nullptr, 0, 0, 0, 0.0f, 0, net, nullptr});
  }
  switch (net->kind) {
    case ctt::kNetGRU:
      return ctt::rnn_blocks_per_sm(ctt::recurrent_cost_rollout_kernel<Cost, 3>, allowed_gru,
                                    *net, Cost::S, Cost::U);
    case ctt::kNetLSTM:
      return ctt::rnn_blocks_per_sm(ctt::recurrent_cost_rollout_kernel<Cost, 4>, allowed_lstm,
                                    *net, Cost::S, Cost::U);
    default:
      return 0;
  }
}

// The group of net_plants_<group>.cu that holds the instances over the cost
// of plant id `plant` (-1: none, cartpole's are this source's).
extern "C" int ctt_net_group(int plant) { return ctt::net_group(plant); }
