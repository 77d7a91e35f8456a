// K7: rollout cost J and its gradient dJ/dQ over K control sequences, as a
// forward launch and a time-parallel adjoint launch.
//
// Replaces control_toolkit_tpu/ops/pallas_grad.py:build_grad_cost_rollout_kernel
// (body _make_fwd_bwd_kernel, runner _make_grad_runner; the kernel behind
// kernel_families/ode.py:build_grad).  Python wrapper and plain version:
// ops/grad_cost_rollout.py.  The Pallas kernel got its backward from
// jax.vjp at trace time; here the derivatives are written by hand
// (plants.cuh derivs_tangent / stage_cost_vjp / terminal_cost_grad,
// rollout_core.cuh integrate_jac), transcribed from ops/adjoints.py.
//
// The forward is a nonlinear recurrence; the backward is linear in the
// cotangent once the forward's states are known.  With ct = 1/(H+1),
// A_h = d x_{h+1} / d x_h [S,S] and B_h = d x_{h+1} / d u_h [S,U] (one
// control period: every sub-step), and (gx_h, gu_h, gprev_h) the stage
// cost's gradient at (x_h, u_h, u_{h-1}):
//   lam_H = ct * d terminal / d x_H
//   dQ_h  = (B_h^T lam_{h+1} + gu_h) + gprev_{h+1}      gprev_H = 0
//   lam_h = A_h^T lam_{h+1} + gx_h
// prev at h = 0 is the packed __u_prev, which gets no gradient.
//
// Both launches serve one session (ks = K) or, in their session-row form
// (the slot_keys form, pallas_grad.py:348), B sessions of ks rollouts,
// rollout k reading row k / ks of pvec (its session's constants, cost,
// attributes and previous control).  A forward block of kThreads and an
// adjoint block of kAdjRollouts may straddle two sessions: each thread
// reads its own rollout's row.  xhist keeps its [H+1, S, B*ks] layout.
// As K1's, each form is an instantiation (Rows) of its single-session
// kernel, which reads row 0 at a grid-uniform address and is unchanged.
// The adjoint's registers are capped at 128 (two blocks an SM): per-thread
// parameters in registers would spill there, so its session-row form
// stages its kAdjRollouts rows in shared memory and reads them from there.
//
// Forward launch (grad_cost_forward_kernel): one thread owns one rollout,
// K1's arithmetic bit for bit (Rollout::advance); it writes cost[k] and
// the states x_0..x_H to the wrapper-allocated scratch xhist [H+1, S, K],
// rollout index fastest (a warp's access to one (h, i) is 128 contiguous
// bytes; 13.4 MB at K=16384, H=50, S=4, which the H100's 50 MB L2 keeps
// for the adjoint launch).
//
// Adjoint launch (grad_cost_adjoint_kernel): everything expensive in the
// backward — the Jacobians, each a forward-mode pass through the period's
// plant evaluations with sinf, cosf and divisions, and the stage terms —
// depends on one (k, h) alone, K*H = 819,200 independent items at the main
// shape where the old one-thread-per-rollout sweep had 16,384 chains.  A
// block owns kAdjRollouts rollouts; its kAdjThreads threads compute one
// item each, kAdjSteps steps of all its rollouts at a time (thread t: step
// t / kAdjRollouts, rollout t % kAdjRollouts), into shared memory laid out
// [step][field][rollout]; after a barrier, one thread per rollout runs the
// short linear chain over those steps (S*S + S*U multiply-adds a step),
// last chunk first, carrying lam and gprev in registers; a second barrier
// frees the chunk.  H is a runtime value of any size: the chunk is fixed.
//
// What bounds it on an H100: the item computation's FP32 work (four
// Jacobian-tangent products of the plant a rk4 sub-step), now
// spread over kAdjThreads-thread blocks, K/kAdjRollouts of them; the
// chain's share is ~S*(S+U) dependent-free multiply-adds a step on 1/32
// of the threads.  The history traffic (2 x 13.4 MB, mostly L2) is
// secondary.  Q and dQ stay in their [K, H, U] layout, read and written
// strided, as K1 reads Q.
//
// The value_spec form (pallas_grad.py:119-141, :186-200): a learned
// terminal value V, a tanh MLP from the state to one number (its scale
// folded into its last layer by the caller), with
//   cost  = (acc + terminal(x_H) + V(x_H)) / (H+1)
//   lam_H = ct * (d terminal / d x_H + dV / d x_H).
// The forward launch's value instance (grad_cost_forward_value_kernel)
// evaluates V and its VJP in its tail, one thread a rollout: each block
// stages the net's 2L operands in shared memory once (4.9 KB for
// 4-32-32-1), a thread's hidden activations go to its own column of a
// [units][kThreads] shared array (32 KB at 64 units), which the VJP
// overwrites with the layers' cotangents, last layer first; it writes
// ct * dV/dx_H to vgrad [S, K].  The adjoint launch's value instance adds
// vgrad to lam after Plant::terminal_cost_grad on its step-0 threads.  The
// adjoint runs at its 128-register cap, two blocks an SM: the MLP there
// would spill, the forward has the room.  The activations sit in shared
// memory, not registers, because the net's widths are run-time values.
// The net's tensors come in by pointer (ValueArgs) on every call, so a
// re-fit or a changed scale rebuilds nothing.  V and its VJP are
// value_mlp.cuh's, which K8, K9 and K10 share.  Both value instances have
// a session-row form (slot_keys + value_spec: the gradient fleets, every
// session under the one V), grad_cost_forward_value_rows_kernel and
// grad_cost_adjoint_value_rows_kernel over the same bodies.  The instances
// without the value compile as before.
//
// The pendulum, acrobot and point-mass plants (plants.cuh, with their fast
// plants) take the forward and the adjoint: their derivs_tangent is their
// Jacobian's nontrivial rows, their stage terms their costs'
// stage_cost_vjp.  An item's fields are S*(S+U) + S + 2U (odd): 11 floats
// for the pendulum, 27 for the acrobot (cartpole's 27) and 33 for the point
// mass, whose adjoint block so takes 33.8 KB of static shared memory.  The
// quadrotor, car and arm plants take the same two launches; the adjoint's
// geometry is the plant's (AdjGeometry): the planar quadrotor's 59 fields
// a step take 16 steps a chunk, the 3-D quadrotor's 213 four, and its
// 12 x 16 tangent goes through the period four columns at a time
// (integrate_jac<Plant, N0>), the primal re-run for each four, where the
// whole tangent and its rk4 stages spilled 5 KB a thread.  Cartpole's and
// the other plants' instances keep 32 steps, 256 threads and their code.
//
// Every plant also takes both launches' session-row forms (the rpgd-tf
// and gradient-tf fleets).  The adjoint's adds its block's 8 parameter
// rows to the chunk's items in static shared memory: 8 * kN floats, from
// 384 B (the point mass) to 832 B (car/obstacles); the largest block,
// car/obstacles', so takes 34.6 KB, the 3-D quadrotor's 28.1 KB, within
// the 48 KB static limit at every plant's own step tile.  Where a block
// has fewer threads than the rows have floats (the planar quadrotor's
// 128 for 136, the 3-D quadrotor's 32 for 200), its threads stage them in
// turns; cartpole's instance stages them as before.
//
// Every plant also takes both value_spec instances and their session-row
// forms.  V adds no shared memory to the adjoint: its instance reads
// vgrad, which the forward wrote, into lam on its step-0 threads, so the
// adjoint keeps the plant's geometry (AdjGeometry) and its static shared
// memory; the forward's dynamic shared memory holds V and a kThreads
// column of activations for each of the net's widest units, whatever the
// plant (value_smem_bytes over the plant's S inputs).  The plants other than
// cartpole's compile their value instances in sources of their own
// (grad_value_plants_<group>.cu), so that K7's source keeps its build time.
//
// This header holds the kernels and their launchers; grad_cost_rollout.cu
// the C entries.
#pragma once

#include "rollout_core.cuh"
#include "value_mlp.cuh"

namespace ctt {

constexpr int kAdjRollouts = 8;                          // rollouts per adjoint block
constexpr int kAdjSteps = 32;                            // steps per chunk, at most
constexpr int kAdjThreads = kAdjRollouts * kAdjSteps;    // one item per thread
constexpr size_t kMaxSmemBytes = 232448;                 // a block's shared memory on sm_90
constexpr int kStaticSmemBytes = 48 * 1024;              // a block's static shared memory

// The most steps a chunk may hold, halving kAdjSteps until kAdjRollouts
// rollouts' items of `fields` floats fit the static shared memory.
constexpr int adj_steps(int fields) {
  int steps = kAdjSteps;
  while (steps > 1 && steps * fields * kAdjRollouts * 4 > kStaticSmemBytes) steps /= 2;
  return steps;
}

// The adjoint's geometry, a plant trait: an item's fields, [A | B]
// row-major (S*N), gx (S), gu (U), gprev (U), an odd count keeping a
// warp's four steps on distinct banks; the steps a chunk (one thread an
// item, kAdjRollouts rollouts a block).  Every plant to S*N + S + 2U = 47
// keeps 32 steps and 256 threads (cartpole, pendulum, acrobot: 27 fields;
// point mass, car, arm: 33); the planar quadrotor's 59 fields take 16 steps
// (30.2 KB), the 3-D quadrotor's 213 four (27.3 KB, 32 threads a block).
// kCols, the tangent's columns an item carries through the period at once:
// all N, but for a tangent of more than 64 entries (the 3-D quadrotor's 12
// x 16), which would spill, four at a time, the primal re-run for each four
// (rollout_core.cuh integrate_jac<Plant, N0>; probes/k7_plant_times.py timed 2,
// 4 and 16 columns, PERF.md).
template <class Plant>
struct AdjGeometry {
  static constexpr int S = Plant::S, U = Plant::U, N = S + U;
  static constexpr int kGx = S * N, kGu = kGx + S, kGp = kGu + U, kFields = (kGp + U) | 1;
  static constexpr int kSteps = adj_steps(kFields);
  static constexpr int kThreads = kAdjRollouts * kSteps;
  static constexpr int kCols = S * N > 64 ? 4 : N;
};

// Columns N0.. of step h's [A | B] (kCols at a time), into the item's
// fields: each chunk integrates the period's tangent from x0.
template <class Plant, int N0, class Field>
__device__ __forceinline__ void jac_columns(const float (&x0)[Plant::S],
                                           const float (&u)[Plant::U], const float* p,
                                           const StepConsts& c, Field&& field) {
  constexpr int S = Plant::S, N = S + Plant::U, NC = AdjGeometry<Plant>::kCols;
  if constexpr (N0 < N) {
    float x[S], T[S][NC];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      x[i] = x0[i];
#pragma unroll
      for (int n = 0; n < NC; ++n) T[i][n] = i == N0 + n ? 1.0f : 0.0f;
    }
    integrate_jac<Plant, N0>(x, u, p, c, T);
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int n = 0; n < NC; ++n) field(i * N + N0 + n) = T[i][n];
    }
    jac_columns<Plant, N0 + NC>(x0, u, p, c, field);
  }
}

// Rollout k from s0 [K, S] under Q [K, H, U], its states x_0..x_H stored
// to xhist [H+1, S, K]: K1's arithmetic bit for bit (Rollout::advance).
template <class Plant>
__device__ __forceinline__ void forward_store(Rollout<Plant>& r, const float* __restrict__ s0,
                                              const float* __restrict__ Q, const float* p,
                                              float* __restrict__ xhist, int K, int H,
                                              const StepConsts& c, float max_cost, int k) {
  constexpr int S = Plant::S, U = Plant::U;
  const float* q = Q + static_cast<size_t>(k) * H * U;
  r.start(s0 + static_cast<size_t>(k) * S, p);
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(h) * S + i) * K + k] = r.x[i];
    float u[U];
#pragma unroll
    for (int j = 0; j < U; ++j) u[j] = __ldg(q + h * U + j);
    r.advance(u, p, c, max_cost);
  }
#pragma unroll
  for (int i = 0; i < S; ++i) xhist[(static_cast<size_t>(H) * S + i) * K + k] = r.x[i];
}

template <class Plant, bool Rows>
__global__ void __launch_bounds__(kThreads)
grad_cost_forward_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                         const float* __restrict__ pvec, float* __restrict__ cost,
                         float* __restrict__ xhist, int K, int ks, int H, StepConsts c,
                         float max_cost) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked
  float p[Plant::kN];
  load_params<Plant>(Rows ? pvec + static_cast<size_t>(k / ks) * Plant::kN : pvec, p);
  Rollout<Plant> r;
  forward_store<Plant>(r, s0, Q, p, xhist, K, H, c, max_cost, k);
  cost[k] = r.finish(p, H);
}

// The forward launch's value_spec body: K7's forward, then V and its VJP
// at x_H (value_mlp.cuh); writes cost, xhist and vgrad [S, K] = ct *
// dV/dx_H.  Its session-row form (Rows) reads rollout k's row k / ks of
// pvec; V is the sessions' own.  Dynamic shared memory:
// value_smem_bytes(v, kThreads).
template <class Plant, bool Rows>
__device__ __forceinline__ void grad_cost_forward_value_body(
    const float* __restrict__ s0, const float* __restrict__ Q, const float* __restrict__ pvec,
    float* __restrict__ cost, float* __restrict__ xhist, float* __restrict__ vgrad, int K, int ks,
    int H, const StepConsts& c, float max_cost, float ct, const ValueArgs& v) {
  constexpr int S = Plant::S;
  extern __shared__ float value_smem[];
  int off = 0;
  for (int l = 0; l < v.n_layers; ++l) {
    const int nw = v.dims[l] * v.dims[l + 1], nb = v.dims[l + 1];
    for (int i = threadIdx.x; i < nw; i += kThreads) value_smem[off + i] = __ldg(v.w[l] + i);
    for (int i = threadIdx.x; i < nb; i += kThreads) value_smem[off + nw + i] = __ldg(v.b[l] + i);
    off += nw + nb;
  }
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;  // ragged K is masked (no barrier follows)
  float p[Plant::kN];
  load_params<Plant>(Rows ? pvec + static_cast<size_t>(k / ks) * Plant::kN : pvec, p);
  Rollout<Plant> r;
  forward_store<Plant>(r, s0, Q, p, xhist, K, H, c, max_cost, k);
  float gx[S];
  const float value = value_forward_vjp<S, kThreads>(r.x, value_smem, v,
                                                     value_smem + off + threadIdx.x, ct, gx);
  cost[k] = (r.acc + (Plant::terminal_cost(r.x, p) + value)) / static_cast<float>(H + 1);
#pragma unroll
  for (int i = 0; i < S; ++i) vgrad[static_cast<size_t>(i) * K + k] = gx[i];
}

// The forward launch's value_spec instance (one session).
template <class Plant>
__global__ void __launch_bounds__(kThreads)
grad_cost_forward_value_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                               const float* __restrict__ pvec, float* __restrict__ cost,
                               float* __restrict__ xhist, float* __restrict__ vgrad, int K,
                               int H, StepConsts c, float max_cost, float ct, ValueArgs v) {
  grad_cost_forward_value_body<Plant, false>(s0, Q, pvec, cost, xhist, vgrad, K, K, H, c,
                                             max_cost, ct, v);
}

// Its session-row form (slot_keys + value_spec, pallas_grad.py:348): B
// sessions of ks rollouts under one V.
template <class Plant>
__global__ void __launch_bounds__(kThreads)
grad_cost_forward_value_rows_kernel(const float* __restrict__ s0, const float* __restrict__ Q,
                                    const float* __restrict__ pvec, float* __restrict__ cost,
                                    float* __restrict__ xhist, float* __restrict__ vgrad, int K,
                                    int ks, int H, StepConsts c, float max_cost, float ct,
                                    ValueArgs v) {
  grad_cost_forward_value_body<Plant, true>(s0, Q, pvec, cost, xhist, vgrad, K, ks, H, c,
                                            max_cost, ct, v);
}

// The adjoint's body: the session-row form (Rows) and the value_spec form
// (Value: lam_H gains vgrad [S, K]) are its instances.
template <class Plant, bool Rows, bool Value>
__device__ __forceinline__ void grad_adjoint_body(const float* __restrict__ Q,
                                                  const float* __restrict__ pvec,
                                                  const float* __restrict__ xhist,
                                                  const float* __restrict__ vgrad,
                                                  float* __restrict__ dQ, int K, int ks, int H,
                                                  const StepConsts& c, float ct) {
  constexpr int S = Plant::S, U = Plant::U, N = S + U;
  using Geo = AdjGeometry<Plant>;
  constexpr int kGx = Geo::kGx, kGu = Geo::kGu, kGp = Geo::kGp, kFields = Geo::kFields;
  constexpr int kSteps = Geo::kSteps;
  __shared__ float items[kSteps * kFields * kAdjRollouts];
  // The session-row form's parameter rows, one a rollout of the block (a
  // rollout past K reads the last one's).
  __shared__ float rows[Rows ? kAdjRollouts * Plant::kN : 1];
  const int r = threadIdx.x % kAdjRollouts, hh = threadIdx.x / kAdjRollouts;
  const int k = blockIdx.x * kAdjRollouts + r;
  const bool live = k < K;  // ragged K: a row past K computes and writes nothing
  float preg[Plant::kN];
  const float* p = preg;
  if constexpr (Rows) {
    constexpr int kRowFloats = kAdjRollouts * Plant::kN;
    if constexpr (Geo::kThreads >= kRowFloats) {
      if (threadIdx.x < kRowFloats) {
        const int kk = min(static_cast<int>(blockIdx.x * kAdjRollouts + threadIdx.x / Plant::kN),
                           K - 1);
        rows[threadIdx.x] =
            __ldg(pvec + static_cast<size_t>(kk / ks) * Plant::kN + threadIdx.x % Plant::kN);
      }
    } else {  // fewer threads than the rows' floats (short chunks, long rows)
      for (int i = threadIdx.x; i < kRowFloats; i += Geo::kThreads) {
        const int kk = min(static_cast<int>(blockIdx.x * kAdjRollouts + i / Plant::kN), K - 1);
        rows[i] = __ldg(pvec + static_cast<size_t>(kk / ks) * Plant::kN + i % Plant::kN);
      }
    }
    __syncthreads();
    p = rows + r * Plant::kN;
  } else {
    load_params<Plant>(pvec, preg);
  }
  auto field = [&](int step, int f) -> float& {
    return items[(step * kFields + f) * kAdjRollouts + r];
  };

  // The chain's state, on the threads of step 0 of each chunk.
  float lam[S], gnext[U];
  if (hh == 0 && live) {
    float x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xhist[(static_cast<size_t>(H) * S + i) * K + k];
    Plant::terminal_cost_grad(x, p, ct, lam);
    if constexpr (Value) {
#pragma unroll
      for (int i = 0; i < S; ++i) lam[i] += __ldg(vgrad + static_cast<size_t>(i) * K + k);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) gnext[j] = 0.0f;
  }
  for (int h0 = (H - 1) / kSteps * kSteps; h0 >= 0; h0 -= kSteps) {
    const int h = h0 + hh;
    if (h < H && live) {
      float x[S], x0[S], u[U], prev[U];
#pragma unroll
      for (int i = 0; i < S; ++i) x0[i] = x[i] = xhist[(static_cast<size_t>(h) * S + i) * K + k];
      const float* q = Q + static_cast<size_t>(k) * H * U;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        u[j] = __ldg(q + h * U + j);
        prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : p[Plant::kUPrev + j];
      }
      float gx[S], gu[U], gp[U];
      if constexpr (Geo::kCols < N) {
        jac_columns<Plant, 0>(x0, u, p, c, [&](int f) -> float& { return field(hh, f); });
        Plant::stage_cost_vjp(x0, u, prev, p, ct, gx, gu, gp);
#pragma unroll
        for (int i = 0; i < S; ++i) field(hh, kGx + i) = gx[i];
      } else {
        float T[S][N];
#pragma unroll
        for (int i = 0; i < S; ++i) {
#pragma unroll
          for (int n = 0; n < N; ++n) T[i][n] = i == n ? 1.0f : 0.0f;
        }
        integrate_jac<Plant>(x, u, p, c, T);
        Plant::stage_cost_vjp(x0, u, prev, p, ct, gx, gu, gp);
#pragma unroll
        for (int i = 0; i < S; ++i) {
#pragma unroll
          for (int n = 0; n < N; ++n) field(hh, i * N + n) = T[i][n];
          field(hh, kGx + i) = gx[i];
        }
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        field(hh, kGu + j) = gu[j];
        field(hh, kGp + j) = gp[j];
      }
    }
    __syncthreads();
    if (hh == 0 && live) {
      float* dq = dQ + static_cast<size_t>(k) * H * U;
      const int steps = H - h0 < kSteps ? H - h0 : kSteps;
      for (int s = steps - 1; s >= 0; --s) {
        float nl[S], du[U];
#pragma unroll
        for (int j = 0; j < S; ++j) nl[j] = 0.0f;
#pragma unroll
        for (int j = 0; j < U; ++j) du[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < S; ++i) {
#pragma unroll
          for (int j = 0; j < S; ++j) nl[j] = fmaf(field(s, i * N + j), lam[i], nl[j]);
#pragma unroll
          for (int j = 0; j < U; ++j) du[j] = fmaf(field(s, i * N + S + j), lam[i], du[j]);
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          dq[(h0 + s) * U + j] = (du[j] + field(s, kGu + j)) + gnext[j];
          gnext[j] = field(s, kGp + j);
        }
#pragma unroll
        for (int i = 0; i < S; ++i) lam[i] = nl[i] + field(s, kGx + i);
      }
    }
    __syncthreads();
  }
}

template <class Plant, bool Rows>
__global__ void __launch_bounds__(AdjGeometry<Plant>::kThreads, 2)
grad_cost_adjoint_kernel(const float* __restrict__ Q, const float* __restrict__ pvec,
                         const float* __restrict__ xhist, float* __restrict__ dQ, int K, int ks,
                         int H, StepConsts c, float ct) {
  grad_adjoint_body<Plant, Rows, false>(Q, pvec, xhist, nullptr, dQ, K, ks, H, c, ct);
}

// The adjoint launch's value_spec instance (one session).
template <class Plant>
__global__ void __launch_bounds__(AdjGeometry<Plant>::kThreads, 2)
grad_cost_adjoint_value_kernel(const float* __restrict__ Q, const float* __restrict__ pvec,
                               const float* __restrict__ xhist, const float* __restrict__ vgrad,
                               float* __restrict__ dQ, int K, int H, StepConsts c, float ct) {
  grad_adjoint_body<Plant, false, true>(Q, pvec, xhist, vgrad, dQ, K, K, H, c, ct);
}

// Its session-row form: B sessions of ks rollouts.
template <class Plant>
__global__ void __launch_bounds__(AdjGeometry<Plant>::kThreads, 2)
grad_cost_adjoint_value_rows_kernel(const float* __restrict__ Q, const float* __restrict__ pvec,
                                    const float* __restrict__ xhist,
                                    const float* __restrict__ vgrad, float* __restrict__ dQ,
                                    int K, int ks, int H, StepConsts c, float ct) {
  grad_adjoint_body<Plant, true, true>(Q, pvec, xhist, vgrad, dQ, K, ks, H, c, ct);
}

// K7's forward over `Plant`: one session (ks = K) or the session-row form.
template <class Plant>
int launch_grad_forward(dim3 grid, cudaStream_t st, const float* s0, const float* Q,
                        const float* pvec, float* cost, float* xhist, int K, int ks, int H,
                        const StepConsts& c, float max_cost) {
  (ks == K ? grad_cost_forward_kernel<Plant, false>
           : grad_cost_forward_kernel<Plant, true>)<<<grid, kThreads, 0, st>>>(
      s0, Q, pvec, cost, xhist, K, ks, H, c, max_cost);
  return static_cast<int>(cudaGetLastError());
}

// Its value_spec instance over `Plant`, with `bytes` of dynamic shared
// memory for V's activations.
template <class Plant>
int launch_grad_forward_value(dim3 grid, cudaStream_t st, long bytes, const float* s0,
                              const float* Q, const float* pvec, float* cost, float* xhist,
                              float* vgrad, int K, int ks, int H, const StepConsts& c,
                              float max_cost, float ct, const ValueArgs& v) {
  if (ks == K) {
    auto kernel = grad_cost_forward_value_kernel<Plant>;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, kThreads, static_cast<size_t>(bytes), st>>>(s0, Q, pvec, cost, xhist, vgrad, K,
                                                                H, c, max_cost, ct, v);
  } else {
    auto kernel = grad_cost_forward_value_rows_kernel<Plant>;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, kThreads, static_cast<size_t>(bytes), st>>>(s0, Q, pvec, cost, xhist, vgrad, K,
                                                                ks, H, c, max_cost, ct, v);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7's adjoint over `Plant`, one session (ks = K) or the session-row form.
template <class Plant>
int launch_grad_adjoint(dim3 grid, cudaStream_t st, const float* Q, const float* pvec,
                        const float* xhist, float* dQ, int K, int ks, int H, const StepConsts& c,
                        float ct) {
  (ks == K ? grad_cost_adjoint_kernel<Plant, false>
           : grad_cost_adjoint_kernel<Plant, true>)<<<grid, AdjGeometry<Plant>::kThreads, 0,
                                                      st>>>(Q, pvec, xhist, dQ, K, ks, H, c, ct);
  return static_cast<int>(cudaGetLastError());
}

// Its value_spec instance over `Plant`, which adds vgrad [S, K] to lam_H.
template <class Plant>
int launch_grad_adjoint_value(dim3 grid, cudaStream_t st, const float* Q, const float* pvec,
                              const float* xhist, const float* vgrad, float* dQ, int K, int ks,
                              int H, const StepConsts& c, float ct) {
  constexpr int threads = AdjGeometry<Plant>::kThreads;
  if (ks == K) {
    grad_cost_adjoint_value_kernel<Plant><<<grid, threads, 0, st>>>(Q, pvec, xhist, vgrad, dQ, K,
                                                                    H, c, ct);
  } else {
    grad_cost_adjoint_value_rows_kernel<Plant><<<grid, threads, 0, st>>>(Q, pvec, xhist, vgrad,
                                                                         dQ, K, ks, H, c, ct);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K7's value_spec forward (adjoint false, `bytes` of dynamic
// shared memory) or adjoint over `Plant` that one SM holds, one session's
// or (rows) the session-row form's; 0 where the runtime cannot say.
template <class Plant>
int grad_value_blocks_per_sm(bool adjoint, bool rows, long bytes) {
  int blocks = 0;
  auto forward = [&](auto kernel) {
    cudaError_t e = cudaSuccess;
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    }
    return e == cudaSuccess ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                  &blocks, kernel, kThreads, static_cast<size_t>(bytes))
                            : e;
  };
  constexpr int adj_threads = AdjGeometry<Plant>::kThreads;
  cudaError_t e;
  if (adjoint && rows) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, grad_cost_adjoint_value_rows_kernel<Plant>, adj_threads, 0);
  } else if (adjoint) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, grad_cost_adjoint_value_kernel<Plant>, adj_threads, 0);
  } else {
    e = rows ? forward(grad_cost_forward_value_rows_kernel<Plant>)
             : forward(grad_cost_forward_value_kernel<Plant>);
  }
  return e == cudaSuccess ? blocks : 0;
}

// Blocks of K7's forward (adjoint false) or adjoint over `Plant` that one
// SM holds, one session's or (Rows) the session-row form's (0 where the
// runtime cannot say).
template <class Plant, bool Rows = false>
int grad_blocks_per_sm(bool adjoint) {
  int blocks = 0;
  const cudaError_t e =
      adjoint ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, grad_cost_adjoint_kernel<Plant, Rows>,
                    AdjGeometry<Plant>::kThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, grad_cost_forward_kernel<Plant, Rows>, kThreads, 0);
  return e == cudaSuccess ? blocks : 0;
}

// The value_spec instances over the plants of ids Ids (a group of the
// pendulum, acrobot, point-mass, quadrotor, car and arm plants), each as
// its cartpole counterpart above (cudaErrorInvalidValue for another id):
// the body of each of the value forms' plant groups.
template <int... Ids>
int launch_grad_forward_value_in(int plant, dim3 grid, cudaStream_t st, long bytes,
                                 const float* s0, const float* Q, const float* pvec, float* cost,
                                 float* xhist, float* vgrad, int K, int ks, int H,
                                 const StepConsts& c, float max_cost, float ct,
                                 const ValueArgs& v) {
  return with_plant_in<Ids...>(plant, [&](auto plant_tag) {
    return launch_grad_forward_value<decltype(plant_tag)>(grid, st, bytes, s0, Q, pvec, cost,
                                                          xhist, vgrad, K, ks, H, c, max_cost, ct,
                                                          v);
  });
}
template <int... Ids>
int launch_grad_adjoint_value_in(int plant, dim3 grid, cudaStream_t st, const float* Q,
                                 const float* pvec, const float* xhist, const float* vgrad,
                                 float* dQ, int K, int ks, int H, const StepConsts& c, float ct) {
  return with_plant_in<Ids...>(plant, [&](auto plant_tag) {
    return launch_grad_adjoint_value<decltype(plant_tag)>(grid, st, Q, pvec, xhist, vgrad, dQ, K,
                                                          ks, H, c, ct);
  });
}
template <int... Ids>
int grad_value_blocks_per_sm_in(int plant, bool adjoint, bool rows, long bytes) {
  int blocks = 0;
  with_plant_in<Ids...>(plant, [&](auto plant_tag) {
    blocks = grad_value_blocks_per_sm<decltype(plant_tag)>(adjoint, rows, bytes);
    return 0;
  });
  return blocks;
}

// The value forms' plant groups, each compiled in a source of its own
// (grad_value_plants_<group>.cu: ids 2-9, then 10-17), so that no source's
// build grows.
inline int grad_value_group(int plant) {
  return plant >= kPlantPendulum && plant <= kPlantQuadrotor2DFast ? 0
         : plant >= kPlantQuadrotor3D && plant <= kPlantArm2Fast ? 1 : -1;
}
template <int Group>
int launch_grad_forward_value_group(int plant, dim3 grid, cudaStream_t st, long bytes,
                                    const float* s0, const float* Q, const float* pvec,
                                    float* cost, float* xhist, float* vgrad, int K, int ks, int H,
                                    const StepConsts& c, float max_cost, float ct,
                                    const ValueArgs& v);
template <int Group>
int launch_grad_adjoint_value_group(int plant, dim3 grid, cudaStream_t st, const float* Q,
                                    const float* pvec, const float* xhist, const float* vgrad,
                                    float* dQ, int K, int ks, int H, const StepConsts& c,
                                    float ct);
template <int Group>
int grad_value_group_blocks_per_sm(int plant, bool adjoint, bool rows, long bytes);
template <> int launch_grad_forward_value_group<0>(int, dim3, cudaStream_t, long, const float*,
                                                   const float*, const float*, float*, float*,
                                                   float*, int, int, int, const StepConsts&,
                                                   float, float, const ValueArgs&);
template <> int launch_grad_forward_value_group<1>(int, dim3, cudaStream_t, long, const float*,
                                                   const float*, const float*, float*, float*,
                                                   float*, int, int, int, const StepConsts&,
                                                   float, float, const ValueArgs&);
template <> int launch_grad_adjoint_value_group<0>(int, dim3, cudaStream_t, const float*,
                                                   const float*, const float*, const float*,
                                                   float*, int, int, int, const StepConsts&,
                                                   float);
template <> int launch_grad_adjoint_value_group<1>(int, dim3, cudaStream_t, const float*,
                                                   const float*, const float*, const float*,
                                                   float*, int, int, int, const StepConsts&,
                                                   float);
template <> int grad_value_group_blocks_per_sm<0>(int, bool, bool, long);
template <> int grad_value_group_blocks_per_sm<1>(int, bool, bool, long);

}  // namespace ctt
