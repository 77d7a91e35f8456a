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
// plants) take the single-session forward and adjoint alone: their
// derivs_tangent is their Jacobian's nontrivial rows, their stage terms
// their costs' stage_cost_vjp.  An item's fields are S*(S+U) + S + 2U (odd):
// 11 floats for the pendulum, 27 for the acrobot (cartpole's 27) and 33 for
// the point mass, whose adjoint block so takes 33.8 KB of static shared
// memory.  The value_spec and session-row forms stay cartpole's
// (ops/kernels.py KERNEL_PLANTS).
#include "rollout_core.cuh"
#include "value_mlp.cuh"

namespace ctt {

constexpr int kAdjRollouts = 8;                          // rollouts per adjoint block
constexpr int kAdjSteps = 32;                            // steps per chunk
constexpr int kAdjThreads = kAdjRollouts * kAdjSteps;    // one item per thread
constexpr size_t kMaxSmemBytes = 232448;                 // a block's shared memory on sm_90

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
  // An item's fields: [A | B] row-major (S*N), gx (S), gu (U), gprev (U);
  // an odd field count keeps a warp's four steps on distinct banks.
  constexpr int kGx = S * N, kGu = kGx + S, kGp = kGu + U, kFields = (kGp + U) | 1;
  __shared__ float items[kAdjSteps * kFields * kAdjRollouts];
  // The session-row form's parameter rows, one a rollout of the block (a
  // rollout past K reads the last one's).
  __shared__ float rows[Rows ? kAdjRollouts * Plant::kN : 1];
  const int r = threadIdx.x % kAdjRollouts, hh = threadIdx.x / kAdjRollouts;
  const int k = blockIdx.x * kAdjRollouts + r;
  const bool live = k < K;  // ragged K: a row past K computes and writes nothing
  float preg[Plant::kN];
  const float* p = preg;
  if constexpr (Rows) {
    if (threadIdx.x < kAdjRollouts * Plant::kN) {
      const int kk = min(static_cast<int>(blockIdx.x * kAdjRollouts + threadIdx.x / Plant::kN),
                         K - 1);
      rows[threadIdx.x] =
          __ldg(pvec + static_cast<size_t>(kk / ks) * Plant::kN + threadIdx.x % Plant::kN);
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
  for (int h0 = (H - 1) / kAdjSteps * kAdjSteps; h0 >= 0; h0 -= kAdjSteps) {
    const int h = h0 + hh;
    if (h < H && live) {
      float x[S], x0[S], u[U], prev[U], T[S][N];
#pragma unroll
      for (int i = 0; i < S; ++i) x0[i] = x[i] = xhist[(static_cast<size_t>(h) * S + i) * K + k];
      const float* q = Q + static_cast<size_t>(k) * H * U;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        u[j] = __ldg(q + h * U + j);
        prev[j] = h > 0 ? __ldg(q + (h - 1) * U + j) : p[Plant::kUPrev + j];
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
#pragma unroll
        for (int n = 0; n < N; ++n) T[i][n] = i == n ? 1.0f : 0.0f;
      }
      integrate_jac<Plant>(x, u, p, c, T);
      float gx[S], gu[U], gp[U];
      Plant::stage_cost_vjp(x0, u, prev, p, ct, gx, gu, gp);
#pragma unroll
      for (int i = 0; i < S; ++i) {
#pragma unroll
        for (int n = 0; n < N; ++n) field(hh, i * N + n) = T[i][n];
        field(hh, kGx + i) = gx[i];
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
      const int steps = H - h0 < kAdjSteps ? H - h0 : kAdjSteps;
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
__global__ void __launch_bounds__(kAdjThreads, 2)
grad_cost_adjoint_kernel(const float* __restrict__ Q, const float* __restrict__ pvec,
                         const float* __restrict__ xhist, float* __restrict__ dQ, int K, int ks,
                         int H, StepConsts c, float ct) {
  grad_adjoint_body<Plant, Rows, false>(Q, pvec, xhist, nullptr, dQ, K, ks, H, c, ct);
}

// The adjoint launch's value_spec instance (one session).
template <class Plant>
__global__ void __launch_bounds__(kAdjThreads, 2)
grad_cost_adjoint_value_kernel(const float* __restrict__ Q, const float* __restrict__ pvec,
                               const float* __restrict__ xhist, const float* __restrict__ vgrad,
                               float* __restrict__ dQ, int K, int H, StepConsts c, float ct) {
  grad_adjoint_body<Plant, false, true>(Q, pvec, xhist, vgrad, dQ, K, K, H, c, ct);
}

// Its session-row form: B sessions of ks rollouts.
template <class Plant>
__global__ void __launch_bounds__(kAdjThreads, 2)
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

// K7's adjoint over `Plant`, or its value_spec instance where vgrad is not
// null; one session (ks = K) or the session-row form.
template <class Plant>
int launch_grad_adjoint(dim3 grid, cudaStream_t st, const float* Q, const float* pvec,
                        const float* xhist, const float* vgrad, float* dQ, int K, int ks, int H,
                        const StepConsts& c, float ct) {
  if (vgrad != nullptr && ks == K) {
    grad_cost_adjoint_value_kernel<Plant><<<grid, kAdjThreads, 0, st>>>(Q, pvec, xhist, vgrad, dQ,
                                                                        K, H, c, ct);
  } else if (vgrad != nullptr) {
    grad_cost_adjoint_value_rows_kernel<Plant><<<grid, kAdjThreads, 0, st>>>(
        Q, pvec, xhist, vgrad, dQ, K, ks, H, c, ct);
  } else {
    (ks == K ? grad_cost_adjoint_kernel<Plant, false>
             : grad_cost_adjoint_kernel<Plant, true>)<<<grid, kAdjThreads, 0, st>>>(
        Q, pvec, xhist, dQ, K, ks, H, c, ct);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7's single-session forward and adjoint over `Plant`: the only forms that
// the pendulum, acrobot and point-mass plants carry.
template <class Plant>
int launch_grad_forward_single(dim3 grid, cudaStream_t st, const float* s0, const float* Q,
                               const float* pvec, float* cost, float* xhist, int K, int H,
                               const StepConsts& c, float max_cost) {
  grad_cost_forward_kernel<Plant, false><<<grid, kThreads, 0, st>>>(s0, Q, pvec, cost, xhist, K,
                                                                    K, H, c, max_cost);
  return static_cast<int>(cudaGetLastError());
}
template <class Plant>
int launch_grad_adjoint_single(dim3 grid, cudaStream_t st, const float* Q, const float* pvec,
                               const float* xhist, float* dQ, int K, int H, const StepConsts& c,
                               float ct) {
  grad_cost_adjoint_kernel<Plant, false><<<grid, kAdjThreads, 0, st>>>(Q, pvec, xhist, dQ, K, K,
                                                                       H, c, ct);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K7's single-session forward (adjoint false) or adjoint over
// `Plant` that one SM holds (0 where the runtime cannot say).
template <class Plant>
int grad_blocks_per_sm(bool adjoint) {
  int blocks = 0;
  const cudaError_t e =
      adjoint ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, grad_cost_adjoint_kernel<Plant, false>, kAdjThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, grad_cost_forward_kernel<Plant, false>, kThreads, 0);
  return e == cudaSuccess ? blocks : 0;
}

}  // namespace ctt

// Launch K7's forward on `stream` over K rollouts, sessions of ks (pvec
// holds K / ks rows, rollout k reading row k / ks: ks = K for one session,
// the session-row form for a fleet); returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unknown plant, a ks that does not
// divide K, or a session-row form over a plant that has none: the
// pendulum, acrobot and point-mass plants take ks = K).  xhist is scratch
// of (H+1)*S*K floats that the caller allocates.
extern "C" int ctt_grad_cost_forward(int plant, const void* s0, const void* Q, const void* pvec,
                                     void* cost, void* xhist, int K, int ks, int H, int rk4,
                                     int substeps, float sub_dt, float half_dt, float dt6,
                                     float max_cost, void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s0f = static_cast<const float*>(s0);
  const auto* qf = static_cast<const float*>(Q);
  const auto* pf = static_cast<const float*>(pvec);
  auto* costf = static_cast<float*>(cost);
  auto* xf = static_cast<float*>(xhist);
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_grad_forward<ctt::CartpolePlant>(grid, st, s0f, qf, pf, costf, xf, K, ks,
                                                          H, c, max_cost);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_grad_forward<ctt::CartpoleFastPlant>(grid, st, s0f, qf, pf, costf, xf, K,
                                                              ks, H, c, max_cost);
    default:
      if (ks != K) return static_cast<int>(cudaErrorInvalidValue);
      return ctt::with_slice_plant(plant, [&](auto plant_tag) {
        return ctt::launch_grad_forward_single<decltype(plant_tag)>(grid, st, s0f, qf, pf, costf,
                                                                    xf, K, H, c, max_cost);
      });
  }
}

// The forward value instance's dynamic shared memory for the net of v, or
// -1 where the kernel refuses the net (a layer count outside
// 1..kMaxValueLayers, an input width other than S, an output width other
// than 1, or more than a block's shared memory).
extern "C" long ctt_value_smem_bytes(const ctt::ValueArgs* v, int S) {
  if (!ctt::value_net_ok(*v, S)) return -1;
  const size_t bytes = ctt::value_smem_bytes(*v, ctt::kThreads);
  return bytes > ctt::kMaxSmemBytes ? -1 : static_cast<long>(bytes);
}

// Launch K7's forward value_spec instance on `stream` over K rollouts,
// sessions of ks as ctt_grad_cost_forward's (ks = K: one session, else its
// session-row form, every session under V): the forward's outputs and
// vgrad [S, K] = ct * dV/dx_H of the net of v; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown plant, a ks that
// does not divide K or a net that ctt_value_smem_bytes refuses).
extern "C" int ctt_grad_cost_forward_value(int plant, const void* s0, const void* Q,
                                           const void* pvec, void* cost, void* xhist,
                                           void* vgrad, int K, int ks, int H, int rk4,
                                           int substeps, float sub_dt, float half_dt, float dt6,
                                           float max_cost, float ct, const ctt::ValueArgs* v,
                                           void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  // The value_spec forms are cartpole's alone (ops/kernels.py KERNEL_PLANTS).
  if (plant != ctt::kPlantCartpole && plant != ctt::kPlantCartpoleFast) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kThreads - 1) / ctt::kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  const long bytes = ctt_value_smem_bytes(v, ctt::CartpolePlant::S);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s0f = static_cast<const float*>(s0);
  const auto* qf = static_cast<const float*>(Q);
  const auto* pf = static_cast<const float*>(pvec);
  auto* costf = static_cast<float*>(cost);
  auto* xf = static_cast<float*>(xhist);
  auto* vf = static_cast<float*>(vgrad);
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_grad_forward_value<ctt::CartpolePlant>(
          grid, st, bytes, s0f, qf, pf, costf, xf, vf, K, ks, H, c, max_cost, ct, *v);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_grad_forward_value<ctt::CartpoleFastPlant>(
          grid, st, bytes, s0f, qf, pf, costf, xf, vf, K, ks, H, c, max_cost, ct, *v);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch K7's adjoint on `stream` over the forward's xhist, sessions of ks
// as the forward's, or, with vgrad not null, its value_spec instance
// (its session-row form where ks < K), which adds vgrad [S, K] to lam_H;
// returns as above (the pendulum, acrobot and point-mass plants take ks = K
// and no vgrad).
extern "C" int ctt_grad_cost_adjoint(int plant, const void* Q, const void* pvec,
                                     const void* xhist, const void* vgrad, void* dQ, int K,
                                     int ks, int H, int rk4, int substeps, float sub_dt,
                                     float half_dt, float dt6, float ct, void* stream) {
  if (ks < 1 || K % ks != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ctt::StepConsts c{rk4, substeps, sub_dt, half_dt, dt6};
  const dim3 grid((K + ctt::kAdjRollouts - 1) / ctt::kAdjRollouts);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(Q);
  const auto* pf = static_cast<const float*>(pvec);
  const auto* xf = static_cast<const float*>(xhist);
  const auto* vf = static_cast<const float*>(vgrad);
  auto* dqf = static_cast<float*>(dQ);
  switch (plant) {
    case ctt::kPlantCartpole:
      return ctt::launch_grad_adjoint<ctt::CartpolePlant>(grid, st, qf, pf, xf, vf, dqf, K, ks, H,
                                                          c, ct);
    case ctt::kPlantCartpoleFast:
      return ctt::launch_grad_adjoint<ctt::CartpoleFastPlant>(grid, st, qf, pf, xf, vf, dqf, K,
                                                              ks, H, c, ct);
    default:
      if (ks != K || vf != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return ctt::with_slice_plant(plant, [&](auto plant_tag) {
        return ctt::launch_grad_adjoint_single<decltype(plant_tag)>(grid, st, qf, pf, xf, dqf, K,
                                                                    H, c, ct);
      });
  }
}

// Blocks of K7's single-session forward (adjoint 0) or adjoint (1) over
// `plant` that one SM holds (0 where the runtime cannot say or the plant
// has no instance).
extern "C" int ctt_grad_cost_plant_blocks_per_sm(int plant, int adjoint) {
  if (plant == ctt::kPlantCartpole) return ctt::grad_blocks_per_sm<ctt::CartpolePlant>(adjoint);
  if (plant == ctt::kPlantCartpoleFast) {
    return ctt::grad_blocks_per_sm<ctt::CartpoleFastPlant>(adjoint);
  }
  if (!ctt::is_slice_plant(plant)) return 0;
  return ctt::with_slice_plant(plant, [&](auto plant_tag) {
    return ctt::grad_blocks_per_sm<decltype(plant_tag)>(adjoint);
  });
}

// Blocks of K7's forward kernel (rows 0) or of its session-row form (rows
// 1) that one SM holds (0 where the runtime cannot say).
extern "C" int ctt_grad_cost_forward_blocks_per_sm(int rows) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks,
          rows ? ctt::grad_cost_forward_kernel<ctt::CartpolePlant, true>
               : ctt::grad_cost_forward_kernel<ctt::CartpolePlant, false>,
          ctt::kThreads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// Blocks of K7's adjoint kernel (rows 0) or of its session-row form (rows
// 1) that one SM holds (0 where the runtime cannot say).
extern "C" int ctt_grad_cost_adjoint_blocks_per_sm(int rows) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks,
          rows ? ctt::grad_cost_adjoint_kernel<ctt::CartpolePlant, true>
               : ctt::grad_cost_adjoint_kernel<ctt::CartpolePlant, false>,
          ctt::kAdjThreads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}
