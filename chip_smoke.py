"""Drive the torch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main paths are the "mpc" controller over the rk4 "ODE" predictor on
the cartpole plant and the cartpole/default cost, closed-loop against
CartpoleEnv at K=16384 rollouts, H=50, inducing period 10, seed 0, with
the "mppi" optimizer (the flagship) and with the gradient optimizers
"rpgd-tf" and "gradient-tf".  Phases, each printing one line of its
numbers:

1. build the CUDA kernels from control_toolkit_tpu_torch/csrc with nvcc;
2. K1 (cost_rollout) and 3. K2 (mppi_cost) against their plain PyTorch
   versions on the card, at the main path's shapes, with CUDA-event times;
4. 200 closed-loop MPPI ticks on the default (semi-fused, K2) path, with a
   target change midway that must not rebuild anything;
5. 50 MPPI ticks with semi_fused=False (the modular path, K1);
6. one MPPI update on the card against the same update on the CPU;
7. K7 (grad_cost_rollout) against its plain version on the card, and the
   dQ bound against K7's output with one stage-gradient term wrong;
8. 200 closed-loop rpgd-tf ticks (two K7 launches and one K1 per tick),
   with the target change at tick 100;
9. 50 closed-loop gradient-tf ticks (five K7 launches and one K1 per tick);
10. one rpgd-tf update on the card against the same update on the CPU.

The learned-dynamics paths: the same controllers over the committed nets
(control_toolkit_tpu_torch/assets/cartpole, predictor specification
"neural:<net>:<assets>"), mlp-64-64 and GRU-5IN-32H1-32H2-4OUT:
11. K11 (neural_cost_rollout) against its plain version, and the cost bound
    against the plain version's output with norm_out dropped and with tanh
    on the last layer;
12. K8 (neural_grad_cost_rollout) against its plain version, and the dQ
    bound against dQ with one layer's tanh' dropped, the delta form's
    identity dropped, and norm_in's scaling dropped in the backward;
13. K13 (recurrent_cost_rollout) against its plain version, for the GRU
    and for an LSTM of the same widths (seeded random weights);
14. 200 closed-loop MPPI ticks over the MLP (one K11 launch per tick), with
    the target change at tick 100;
15. 200 closed-loop rpgd-tf ticks over the MLP (two K8 and one K11);
16. 50 closed-loop MPPI ticks over the GRU (one K13), and the hidden the
    card carried against a CPU replay of the recorded states and controls;
17. one update on the card against the same update on the CPU, for MPPI
    over the MLP, MPPI over the GRU (hidden included) and rpgd-tf over the
    MLP.

Float32 products on the card run in full float32: the script sets
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.
allow_tf32`` to False before any work, so the plain versions' matmuls are
not TF32.

    python3 chip_smoke.py [--starts] [--profile]

``--starts`` adds, after phase 17, 18 closed loops of each of MPPI and
rpgd-tf over the MLP from other start states and seeds (``start_sweep``);
``--profile`` a ``torch.profiler`` trace of 20 ticks (after 30 warm-up
ticks) of each path, printing per tick the device busy time, the number of
device operations and the costliest device kernels.

Every kernel's launch count is set to 0 just before each closed loop and
read just after it; launches made to compare a kernel with its plain
version are not counted.  No phase catches its own failure: any mismatch
raises and the exit code is not 0.  Without a card it raises before
printing any result.  The last line is the JSON result; the line before it
lists the kernels, each with its launches over the closed loops, its error
against its plain version, its and its plain version's CUDA-event times,
and its bound: the larger of the bytes it must move over 3.35 TB/s and its
FP32 operations (counted from the shapes, see ``kernel_ops``) over
67 TFLOP/s, the H100 SXM's published peaks.
Imports nothing of JAX and nothing of the JAX package (it passes every
config explicitly, so no config file is read).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.models.networks import gru_apply, gru_init_state
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost, mppi_cost_plain
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
    neural_grad_cost_rollout, neural_grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.neural_rollout import (
    mlp_layer_count, neural_cost_rollout, neural_cost_rollout_plain, plain_cost_loop,
    recurrent_cost_rollout, recurrent_cost_rollout_plain,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import neural, ode
from control_toolkit_tpu_torch.utils.convert import mppi_state_from_numpy, rpgd_state_from_numpy
from control_toolkit_tpu_torch.utils.device import resolve_device

K, H, PERIOD, SEED, DT = 16384, 50, 10, 0, 0.02
TICKS, MODULAR_TICKS, RETARGET_AT, NEW_TARGET = 200, 50, 100, 0.1
RPGD_TICKS, GRADIENT_TICKS = 200, 50
# config_cost_function.yml, cartpole/default.
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
OPTIMIZER_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                    "cc_weight": 1.0, "R": 1.0, "LBD": 100.0, "NU": 1000.0,
                    "SQRTRHOINV": 0.03, "period_interpolation_inducing_points": PERIOD}
# bench_scale.py:build_rpgd's configuration.
RPGD_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
               "outer_its": 2, "SAMPLING_DISTRIBUTION": "uniform",
               "period_interpolation_inducing_points": PERIOD, "learning_rate": 0.05,
               "gradmax_clip": 5, "opt_keep_k_ratio": 0.25, "resamp_per": 10,
               "sample_stdev": 0.5, "warmup": False, "warmup_iterations": 2}
GRADIENT_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                   "gradient_steps": 5, "learning_rate": 0.05, "gradmax_clip": 5}
LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
# Kernel vs plain version on the same card tensors: nvcc contracts a*b+c
# into FMA, the plain version's separate ops do not; from states near
# upright the 50-step rollouts stay within float32 rounding of each other.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-3)
# One full update on the card vs on the CPU (plain versions): costs agree
# to the kernel tolerance, the softmax-weighted plan far tighter.
UNOM_ATOL = 1e-4
# K7 vs its plain version: J to KERNEL_TOL; dQ to rtol 2e-5 plus an
# absolute 5e-6 of its largest entry (0.01 at max|dQ| ~2e3).  The adjoint
# sweep amplifies the forward's rounding (FMA contraction) to ~1e-6 of
# max|dQ|; one term of the stage gradient dropped or put on the wrong step
# moves dQ by up to 2*cc*R/(H+1) = 0.04 (control cost) or 4*ccrc/(H+1) =
# 0.08 (control change), and phase 7 checks that the bound rejects each.
DQ_RTOL, DQ_ATOL_FRAC = 2e-5, 5e-6
# The rpgd-tf update on the card vs on the CPU: its K1 costs are taken at
# populations that already differ by the Adam loop's rounding; they, the
# population and the Adam moments are held to rtol 1e-3 plus 1e-3 of the
# largest entry.
UPDATE_RTOL, UPDATE_ATOL_FRAC = 1e-3, 1e-3
PROFILE_WARMUP, PROFILE_TICKS = 30, 20
COUNTED = {"cost_rollout": cost_rollout, "mppi_cost": mppi_cost,
           "grad_cost_rollout": grad_cost_rollout, "neural_cost_rollout": neural_cost_rollout,
           "recurrent_cost_rollout": recurrent_cost_rollout,
           "neural_grad_cost_rollout": neural_grad_cost_rollout}
# The learned-dynamics paths over the committed nets.
ASSETS = kernels.PACKAGE_DIR / "assets" / "cartpole"
MLP_SPEC = f"neural:mlp-64-64:{ASSETS}"
GRU_SPEC = f"neural:GRU-5IN-32H1-32H2-4OUT:{ASSETS}"
LSTM_SPEC = "neural:LSTM-5IN-32H1-32H2-4OUT"  # no checkpoint: seeded random weights
MLP_TICKS, MLP_RPGD_TICKS, GRU_TICKS = 200, 200, 50
# The learned loops start from the state the JAX package's CartpoleEnv(seed=0)
# starts from, the run this configuration was checked with there.  MPPI's
# closed loop over mlp-64-64 is marginal over 200 ticks: over 9 start
# states (that one and this package's CartpoleEnv seeds 0-7) and 2
# optimizer seeds, on an H100, MPPI kept the pole up in 10 of 18 runs (both
# from this start) and drifted off with the net's bias in the others, while
# rpgd-tf kept it up in all 18 (``--starts`` repeats the sweep).  The JAX
# package's MPPI, from the same starts on the CPU, kept it up in 12 of 18
# and lost it from this package's seed-0 start with both seeds
# (``tests/test_torch_neural.py --starts``).
LEARNED_START = np.array([-0.12212279, -0.10178403, 0.01027721, -0.01767751], np.float32)
# K11 and K13 against their plain versions: the kernels sum each layer with
# FMAs in input order, the plain versions through cuBLAS in full float32.
# On an H100 80GB HBM3 (700 W) the max rel errors at these shapes were
# 6.9e-6 (K11, mlp-64-64), 1.3e-4 (K13, the GRU from an updated hidden;
# 1.8e-4 from a random one) and 3.1e-6 to 3.8e-5 (the LSTM), on costs up to
# ~6e3; the recurrent nets carry the difference through their hidden.  A
# wrong net (norm_out dropped, tanh on the last layer) moves K11's costs by
# a rel 9 and more, and phase 11 checks that the bound rejects both; a
# zero hidden in place of the live one, or the first two gates swapped,
# moves K13's by a rel 30 and more (LSTM; the GRU 1e3), and phase 13
# checks that its bound rejects each.
NET_TOL = dict(rtol=5e-5, atol=1e-3)
RNN_TOL = dict(rtol=1e-3, atol=1e-3)
# K8's dQ is held to K7's bound (rtol 2e-5 plus 5e-6 of max|dQ|): on the
# H100 its error was 1.6e-3 to 1.8e-3 against max|dQ| 1.6e3 (1.1e-6 of it),
# each of phase 12's wrong backwards at least 480.
# The hidden the card carried over the GRU loop against the CPU replay.
HIDDEN_ATOL = 1e-4
# Published H100 SXM peaks (NVIDIA's data sheet), for each kernel's bound.
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
# FP32 operations per rollout-step of the cartpole plant, counted from
# csrc/plants.cuh and rollout_core.cuh (each add, multiply, divide, sine and
# cosine is one; a lower bound, since a division or a sine costs the card
# several): derivs 30, an rk4 step 172 (four derivs and the stage sums),
# the stage cost 24, K2's interpolation, clip and correction 16, K7's
# transposed rk4 step 437 and stage-cost gradient 26 (+6 to combine).
RK4_STEP_OPS, STAGE_OPS, MPPI_EXTRA_OPS, RK4_VJP_OPS, STAGE_VJP_OPS = 172, 24, 16, 437, 32


def emit(phase: str, numbers: dict) -> None:
    print(f"{phase}: {json.dumps(numbers)}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after warm-up."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, kernel_fn, plain_fn, tol=KERNEL_TOL, extra=None) -> dict:
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    numbers = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
        "finite": bool(torch.isfinite(got).all()),
        "ms": cuda_ms(kernel_fn, 50),
        "plain_ms": cuda_ms(plain_fn, 3),
        **(extra(ref) if extra else {}),
    }
    emit(name, numbers)
    check(numbers["finite"] and got.shape == (K,), f"{name}: bad output")
    check(torch.allclose(got, ref, **tol), f"{name}: kernel disagrees with plain {numbers}")
    return numbers


def close(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol_frac: float) -> bool:
    """allclose with the absolute bound a fraction of ref's largest entry."""
    return torch.allclose(got, ref, rtol=rtol, atol=atol_frac * float(ref.abs().max()))


def max_errors(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got - ref).abs()
    return float(err.max()), float((err / ref.abs().clamp_min(1e-6)).max())


def make_controller(device: str, optimizer: str = "mppi", config=None, spec: str = "ODE",
                    **extra) -> MPCController:
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": device})
    ctrl.configure(optimizer_name=optimizer, predictor_specification=spec,
                   optimizer_config={**(config or OPTIMIZER_CONFIG), **extra},
                   cost_function_config=COST_WEIGHTS)
    return ctrl


def counted_loop(name: str, ctrl: MPCController, ticks: int, expected: dict, **loop) -> dict:
    """A closed loop with every kernel's launch count set to 0 just before
    it; checks the counts read just after it against ``expected`` (kernel ->
    launches; every other kernel 0) and returns them."""
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    closed_loop(name, ctrl, ticks, **loop)
    counts = {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}
    check(counts == {kernel: expected.get(kernel, 0) for kernel in COUNTED},
          f"{name}: kernel launches {counts}, expected {expected}")
    return counts


def closed_loop(name: str, ctrl: MPCController, ticks: int, retarget_at=None,
                pole_check: bool = True, trace=None, start=None) -> dict:
    """``ticks`` closed-loop ticks against CartpoleEnv, from its seed's state
    or ``start``; ``trace`` (a list) receives each tick's (state, applied
    control)."""
    env = CartpoleEnv(batch_size=1, dt=DT, seed=SEED)
    s, _ = env.reset()
    if start is not None:
        env.state = torch.tensor(start[None])
        s = start[None].copy()
    builds, epoch = kernels.build.count, ctrl.optimizer._build_epoch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host_ms, device_ms, max_angle = [], [], 0.0
    for t in range(ticks):
        attrs = {"target_position": NEW_TARGET} if t == retarget_at else None
        start.record()
        t0 = time.perf_counter()
        u = ctrl.step(s[0], updated_attributes=attrs)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        check(u.shape == (1,) and bool(np.all(np.isfinite(u))) and abs(float(u[0])) <= 1.0,
              f"{name}: tick {t}: bad control {u}")
        if trace is not None:
            trace.append((s[0].copy(), u.copy()))
        s, *_ = env.step(u)
        max_angle = max(max_angle, abs(float(s[0, 2])))
        check(not pole_check or max_angle < 0.5, f"{name}: tick {t}: the pole fell, state {s[0]}")
    check(kernels.build.count == builds and ctrl.optimizer._build_epoch == epoch,
          f"{name}: something was rebuilt during the loop")
    numbers = {
        "ticks": ticks,
        "step_host_p50_ms": float(np.percentile(host_ms, 50)),
        "step_host_p99_ms": float(np.percentile(host_ms, 99)),
        "step_device_p50_ms": float(np.percentile(device_ms, 50)),
        "step_device_p99_ms": float(np.percentile(device_ms, 99)),
        "max_abs_angle": max_angle,
        "final_state": [float(v) for v in s[0]],
    }
    emit(name, numbers)
    return numbers


def stage_term_mutants(dQ, Q, pvec, model) -> dict:
    """dQ as a K7 would return it that dropped one term of the stage cost's
    gradient or put the control-change term's ``gprev`` on the wrong step
    (dQ_h holds ct*2*cc*R*u_h + change_h - change_{h+1}, with change_h =
    ct*2*ccrc*(u_h - u_{h-1}) and ct = 1/(H+1))."""
    p = model.unpack(pvec)
    ct = 1.0 / (Q.shape[1] + 1)
    prev = torch.cat([p["__u_prev_0"].expand(Q.shape[0], 1, 1), Q[:, :-1]], dim=1)
    change = ct * 2.0 * p["c_ccrc_weight"] * (Q - prev)
    change_next = torch.cat([change[:, 1:], torch.zeros_like(change[:, :1])], dim=1)
    return {"no_control_cost": dQ - ct * 2.0 * p["c_cc_weight"] * p["c_R"] * Q,
            "no_change_cost": dQ - change + change_next,
            "no_gprev": dQ + change_next,
            "gprev_on_step_h": dQ - change + change_next - change}


def compare_grad(model, s0, Q, pvec) -> dict:
    """Phase 7: K7 against its plain version on the same card tensors, and
    the dQ bound against K7's output with one stage-gradient term wrong."""
    (cost, dQ), (ref_cost, ref_dQ) = (grad_cost_rollout(model, s0, Q, pvec),
                                      grad_cost_rollout_plain(model, s0, Q, pvec))
    torch.cuda.synchronize()
    cost_abs, cost_rel = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    mutants = stage_term_mutants(dQ, Q, pvec, model)
    numbers = {
        "cost_max_abs_err": cost_abs, "cost_max_rel_err": cost_rel,
        "dQ_max_abs_err": dq_abs, "dQ_max_abs": float(ref_dQ.abs().max()),
        "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()), "dQ_rtol": DQ_RTOL,
        "mutant_max_abs_err": {name: max_errors(m, ref_dQ)[0] for name, m in mutants.items()},
        "max_abs_err": max(cost_abs, dq_abs),
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
        "ms": cuda_ms(lambda: grad_cost_rollout(model, s0, Q, pvec), 50),
        "plain_ms": cuda_ms(lambda: grad_cost_rollout_plain(model, s0, Q, pvec), 3),
    }
    emit("k7_grad_cost_rollout", numbers)
    check(numbers["finite"] and cost.shape == (K,) and dQ.shape == Q.shape, "K7: bad output")
    check(torch.allclose(cost, ref_cost, **KERNEL_TOL), f"K7: cost disagrees with plain {numbers}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"K7: dQ disagrees with plain {numbers}")
    for name, mutant in mutants.items():
        check(not close(mutant, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC),
              f"K7: the dQ bound does not reject a dQ with {name} {numbers}")
    return numbers


def to_cpu(tree):
    """A params tree (dicts and tuples of tensors) with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def update_vs_cpu_mppi(name: str, ctrl: MPCController, spec: str = "ODE") -> None:
    """Phases 6 and 17: one MPPI update on the card and on the CPU (the
    plain versions) from the card's state and params (a recurrent net's
    live hidden included), with one draw."""
    opt = ctrl.optimizer
    state = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    noise = opt.sample_noise(state)
    params = ctrl._assemble_params()
    _, _, diag = opt.update(state, s_now, params, noise)
    cpu = make_controller("cpu", spec=spec)
    cpu_state = mppi_state_from_numpy(state.u_nom.cpu().numpy(), state.u_prev.cpu().numpy(),
                                      torch.Generator())
    _, _, cpu_diag = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params), noise.cpu())
    numbers = {"u_nom_max_abs_err": float((diag["u_nom"].cpu() - cpu_diag["u_nom"]).abs().max())}
    if "J_logged" in diag:
        numbers["cost_max_abs_err"] = float((diag["J_logged"].cpu() - cpu_diag["J_logged"]).abs().max())
    emit(name, numbers)
    check(numbers["u_nom_max_abs_err"] <= UNOM_ATOL,
          f"{name}: the card's update differs from the CPU's {numbers}")


def update_vs_cpu_rpgd(ctrl: MPCController, name: str = "rpgd_update_vs_cpu",
                       spec: str = "ODE") -> None:
    """Phases 10 and 17: one rpgd-tf update on the card and on the CPU (the
    plain versions) from the card's state and params, on a resample tick,
    with one draw."""
    opt = ctrl.optimizer
    state = opt.opt_state
    check(state.count % opt.resamp_per == 0, f"tick {state.count} is not a resample tick")
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    draw = opt.sample_resample(state)
    params = ctrl._assemble_params()
    u, new, diag = opt.update(state, s_now, params, draw)

    cpu = make_controller("cpu", "rpgd-tf", RPGD_CONFIG, spec=spec)
    host = [t.cpu().numpy() for t in (state.Q, state.adam.m, state.adam.v,
                                      state.trajectory_ages, state.u_prev)]
    cpu_state = rpgd_state_from_numpy(host[0], host[1], host[2], state.adam.step, host[3],
                                      state.count, host[4], torch.Generator())
    uc, new_c, cdiag = cpu.optimizer.update(cpu_state, s_now.cpu(), to_cpu(params), draw.cpu())

    # After the surgery the fresh rows' moments are zero on both sides and
    # each elite's row sits where its side ranked it; costs within rounding
    # of each other may rank near-ties apart, so elites are matched by index.
    cost, cost_c = diag["J_logged"].cpu(), cdiag["J_logged"]
    keep, fresh = opt.opt_keep_k, K - opt.opt_keep_k
    rank, rank_c = (torch.full((K,), -1).index_put_((elite_indices(c, keep),), torch.arange(keep))
                    for c in (cost, cost_c))
    both = (rank >= 0) & (rank_c >= 0)
    rows = torch.cat([torch.arange(fresh), fresh + rank[both]])
    rows_c = torch.cat([torch.arange(fresh), fresh + rank_c[both]])
    pairs = {"Q": (diag["Q_logged"].cpu(), cdiag["Q_logged"]),
             "m": (new.adam.m.cpu()[rows], new_c.adam.m[rows_c]),
             "v": (new.adam.v.cpu()[rows], new_c.adam.v[rows_c]),
             "cost": (cost, cost_c)}
    same_best = int(torch.argmin(cost)) == int(torch.argmin(cost_c))
    numbers = {f"{k}_max_abs_err": max_errors(*ab)[0] for k, ab in pairs.items()}
    numbers.update({"cost_max_rel_err": max_errors(cost, cost_c)[1],
                    "elites_in_both": int(both.sum()), "elites": keep, "same_best": same_best,
                    "u_abs_err": float((u.cpu() - uc).abs().max())})
    emit(name, numbers)
    for k, (a, b) in pairs.items():
        check(close(a, b, UPDATE_RTOL, UPDATE_ATOL_FRAC),
              f"{name}: {k} on the card differs from the CPU {numbers}")
    check(not same_best or close(u.cpu(), uc, UPDATE_RTOL, UPDATE_ATOL_FRAC),
          f"{name}: u differs {numbers}")


# ---- bounds ---------------------------------------------------------------------
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def bound(ops: float, n_bytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def mlp_dims(net) -> list:
    n = mlp_layer_count(net)
    return [net["w0"].shape[0]] + [net[f"w{i}"].shape[1] for i in range(n)]


def mlp_ops(net) -> int:
    """FP32 operations of one MLP step: two per multiply-add and one per bias
    add of each layer, a tanh per hidden unit, two per normalized input and
    output, and the delta add."""
    dims = mlp_dims(net)
    ops = sum(2 * a * b + b for a, b in zip(dims, dims[1:])) + sum(dims[1:-1]) + dims[-1]
    return ops + 2 * dims[0] * ("norm_in_mean" in net) + 2 * dims[-1] * ("norm_out_mean" in net)


def mlp_vjp_ops(net) -> int:
    """The transposed MLP step beyond its forward re-run: two per
    multiply-add of each layer, three per hidden unit for tanh' (a*a, 1 - it,
    times g), one per normalized input and output, and the delta add."""
    dims = mlp_dims(net)
    ops = sum(2 * a * b for a, b in zip(dims, dims[1:])) + 3 * sum(dims[1:-1]) + dims[-1]
    return ops + dims[0] * ("norm_in_mean" in net) + dims[-1] * ("norm_out_mean" in net)


def rnn_ops(net, kind: str) -> int:
    """FP32 operations of one recurrent step: per cell two per multiply-add of
    x @ wi and h @ wh and the two bias adds per gate unit, then per hidden
    unit 17 (GRU: two sigmoids of four, a tanh, the r * gh product and the
    sums, the blend) or 22 (LSTM: three sigmoids, two tanh, the gate sums,
    the c and h updates); the head's multiply-adds and bias; the delta add."""
    gates, per_unit = (3, 17) if kind == "gru" else (4, 22)
    ops, i = 0, 0
    while f"cell{i}" in net:
        d_in, hd = net[f"cell{i}"]["wi"].shape[0], net[f"cell{i}"]["wh"].shape[0]
        ops += 2 * (d_in + hd) * gates * hd + 2 * gates * hd + per_unit * hd
        i += 1
    d, S = net["wo"].shape
    return ops + 2 * d * S + S + S


# ---- the learned-dynamics phases ------------------------------------------------
def net_mutants(net) -> dict:
    """The MLP with norm_out dropped, and with tanh on its last layer (an
    identity layer appended, so the old last layer gets the tanh)."""
    n, S = mlp_layer_count(net), net[f"w{mlp_layer_count(net) - 1}"].shape[1]
    dev = net["w0"].device
    return {"no_norm_out": {k: v for k, v in net.items() if not k.startswith("norm_out")},
            "tanh_on_last_layer": {**net, f"w{n}": torch.eye(S, device=dev),
                                   f"b{n}": torch.zeros(S, device=dev)}}


def compare_neural(model, s0, Q, pvec, net) -> dict:
    """Phase 11: K11 against its plain version, and the cost bound against
    the plain version's output for a wrong net."""
    ref = neural_cost_rollout_plain(model, s0, Q, pvec, net)
    mutants = {name: neural_cost_rollout_plain(model, s0, Q, pvec, m)
               for name, m in net_mutants(net).items()}
    numbers = compare("k11_neural_cost_rollout", lambda: neural_cost_rollout(model, s0, Q, pvec, net),
                      lambda: neural_cost_rollout_plain(model, s0, Q, pvec, net), tol=NET_TOL,
                      extra=lambda _: {"mutant_max_rel_err": {
                          name: max_errors(m, ref)[1] for name, m in mutants.items()},
                          "smem_bytes": model.smem_bytes(model.net_args(net)[0], False)})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **NET_TOL),
              f"K11: the cost bound does not reject a net with {name} {numbers}")
    return numbers


def autograd_dq(model, s0, Q, pvec, net, defect=None) -> torch.Tensor:
    """dQ by torch.autograd through K11's plain arithmetic, with ``defect``
    in the backward only (the forward values stay K11's): ``tanh_prime``
    (the first layer's tanh passes its cotangent through), ``delta_identity``
    (x' = x + net drops the identity path), ``norm_in_scale`` (norm_in's
    cotangent is not divided by std)."""
    def step(x, u):
        a = torch.cat([x, u], dim=1)
        if "norm_in_mean" in net:
            shifted = a - net["norm_in_mean"]
            a = shifted / net["norm_in_std"]
            if defect == "norm_in_scale":
                a = shifted + (a - shifted).detach()
        n = mlp_layer_count(net)
        for i in range(n):
            z = a @ net[f"w{i}"] + net[f"b{i}"]
            a = z if i == n - 1 else torch.tanh(z)
            if defect == "tanh_prime" and i == 0:
                a = z + (a - z).detach()
        if "norm_out_mean" in net:
            a = a * net["norm_out_std"] + net["norm_out_mean"]
        if not model.predict_delta:
            return a
        return (x.detach() if defect == "delta_identity" else x) + a

    with torch.enable_grad():
        Qv = Q.clone().requires_grad_(True)
        (dq,) = torch.autograd.grad(plain_cost_loop(model, s0, Qv, pvec, step).sum(), Qv)
    return dq


def compare_neural_grad(model, s0, Q, pvec, net) -> dict:
    """Phase 12: K8 against its plain version on the same card tensors, and
    the dQ bound against dQ with one defect in the MLP's backward."""
    (cost, dQ), (ref_cost, ref_dQ) = (neural_grad_cost_rollout(model, s0, Q, pvec, net),
                                      neural_grad_cost_rollout_plain(model, s0, Q, pvec, net))
    torch.cuda.synchronize()
    cost_abs, cost_rel = max_errors(cost, ref_cost)
    dq_abs, _ = max_errors(dQ, ref_dQ)
    mutants = {d: autograd_dq(model, s0, Q, pvec, net, d)
               for d in ("tanh_prime", "delta_identity", "norm_in_scale")}
    numbers = {
        "cost_max_abs_err": cost_abs, "cost_max_rel_err": cost_rel,
        "dQ_max_abs_err": dq_abs, "dQ_max_abs": float(ref_dQ.abs().max()),
        "dQ_atol": DQ_ATOL_FRAC * float(ref_dQ.abs().max()), "dQ_rtol": DQ_RTOL,
        "autograd_dQ_max_abs_err": max_errors(autograd_dq(model, s0, Q, pvec, net), ref_dQ)[0],
        "mutant_max_abs_err": {name: max_errors(m, ref_dQ)[0] for name, m in mutants.items()},
        "smem_bytes": model.smem_bytes(model.net_args(net)[0], True),
        "max_abs_err": max(cost_abs, dq_abs),
        "finite": bool(torch.isfinite(cost).all() and torch.isfinite(dQ).all()),
        "ms": cuda_ms(lambda: neural_grad_cost_rollout(model, s0, Q, pvec, net), 20),
        "plain_ms": cuda_ms(lambda: neural_grad_cost_rollout_plain(model, s0, Q, pvec, net), 3),
    }
    emit("k8_neural_grad_cost_rollout", numbers)
    check(numbers["finite"] and cost.shape == (K,) and dQ.shape == Q.shape, "K8: bad output")
    check(torch.allclose(cost, ref_cost, **NET_TOL), f"K8: cost disagrees with plain {numbers}")
    check(close(dQ, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC), f"K8: dQ disagrees with plain {numbers}")
    for name, mutant in mutants.items():
        check(not close(mutant, ref_dQ, DQ_RTOL, DQ_ATOL_FRAC),
              f"K8: the dQ bound does not reject a dQ with {name} dropped {numbers}")
    return numbers


def recurrent_mutants(net, hidden, kind: str) -> dict:
    """(net, hidden) of a wrong K13: the rollouts started from a zero hidden
    in place of the live one, and each cell's first two gates swapped (the
    GRU's r and z, the LSTM's i and f, which puts the forget gate on the
    candidate and the input gate on the old c)."""
    def swap(t, hd):
        return torch.cat([t[..., hd:2 * hd], t[..., :hd], t[..., 2 * hd:]], dim=-1)

    swapped = {k: {name: swap(t, v["wh"].shape[0]) for name, t in v.items()}
               if k.startswith("cell") else v for k, v in net.items()}
    return {"zero_hidden": (net, tuple(torch.zeros_like(h) for h in hidden)),
            ("r_z_swapped" if kind == "gru" else "i_f_swapped"): (swapped, hidden)}


def compare_recurrent(label: str, spec: str, s0, Q, gen) -> tuple:
    """Phase 13: K13 against its plain version for the net of ``spec``, from
    the hidden that ten of the predictor's own updates reach, and the cost
    bound against the plain version's output for a wrong net or hidden."""
    ctrl = make_controller("cuda", spec=spec)
    pred, device = ctrl.optimizer.predictor.predictor, s0.device
    for _ in range(10):
        pred.update(0.05 * torch.randn(1, 4, generator=gen, device=device),
                    torch.clamp(0.3 * torch.randn(1, 1, 1, generator=gen, device=device), -1, 1))
    model, pack = neural.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=device))
    net, hidden = params["dyn"]["net"], params["dyn"]["hidden"]
    ref = recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden)
    mutants = {name: recurrent_cost_rollout_plain(model, s0, Q, pvec, n, h)
               for name, (n, h) in recurrent_mutants(net, hidden, model.kind).items()}
    numbers = compare(label, lambda: recurrent_cost_rollout(model, s0, Q, pvec, net, hidden),
                      lambda: recurrent_cost_rollout_plain(model, s0, Q, pvec, net, hidden),
                      tol=RNN_TOL,
                      extra=lambda _: {"mutant_max_rel_err": {
                          name: max_errors(m, ref)[1] for name, m in mutants.items()},
                          "smem_bytes": model.smem_bytes(model.net_args(net, hidden)[0], False)})
    for name, m in mutants.items():
        check(not torch.allclose(m, ref, **RNN_TOL),
              f"K13: the cost bound does not reject a rollout with {name} {numbers}")
    numbers.update(bound(K * H * (rnn_ops(net, model.kind) + STAGE_OPS),
                         nbytes(s0, Q, pvec, *leaves(net), *hidden) + 4 * K))
    return numbers


def gru_hidden_vs_replay(ctrl: MPCController, trace: list) -> None:
    """Phase 16: the hidden the card carried over the loop against a CPU
    replay: a zero hidden advanced with the plain gru_apply over the
    recorded states and applied controls."""
    pred = ctrl.optimizer.predictor.predictor
    net = to_cpu(pred.net_params)
    hidden = gru_init_state(pred.arch["hiddens"], 1)
    for s, u in trace:
        _, hidden = gru_apply(net, torch.tensor(np.concatenate([s, u]))[None], hidden)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(pred.hidden, hidden))
    numbers = {"ticks": len(trace), "hidden_max_abs_err": err,
               "hidden_max_abs": max(float(h.abs().max()) for h in hidden)}
    emit("gru_hidden_vs_cpu_replay", numbers)
    check(err <= HIDDEN_ATOL, f"the GRU hidden on the card differs from the CPU replay {numbers}")


def start_sweep() -> None:
    """``--starts``: MPPI and rpgd-tf over the committed MLP, 200 ticks with
    the target change, from LEARNED_START and from CartpoleEnv seeds 0-7's
    states, with optimizer seeds 0 and 1: how often the pole stays up."""
    starts = [LEARNED_START] + [CartpoleEnv(batch_size=1, dt=DT, seed=k).reset()[0][0]
                                for k in range(8)]
    for optimizer, config in (("mppi", OPTIMIZER_CONFIG), ("rpgd-tf", RPGD_CONFIG)):
        held = []
        for seed in (0, 1):
            for i, start in enumerate(starts):
                ctrl = make_controller("cuda", optimizer, {**config, "seed": seed}, spec=MLP_SPEC)
                numbers = closed_loop(f"starts_{optimizer}_seed{seed}_start{i}", ctrl, MLP_TICKS,
                                      retarget_at=RETARGET_AT, pole_check=False, start=start)
                held.append(numbers["max_abs_angle"] < 0.5)
        emit(f"starts_{optimizer}", {"runs": len(held), "pole_up_runs": sum(held)})


def profile_ticks(name: str, ctrl: MPCController) -> None:
    """``torch.profiler`` over PROFILE_TICKS closed-loop ticks after
    PROFILE_WARMUP: device busy time and device operations per tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    env = CartpoleEnv(batch_size=1, dt=DT, seed=SEED)
    s, _ = env.reset()
    for _ in range(PROFILE_WARMUP):
        s, *_ = env.step(ctrl.step(s[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            s, *_ = env.step(ctrl.step(s[0]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_TICKS
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3 / PROFILE_TICKS
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    emit(f"profile_{name}", {
        "ticks": PROFILE_TICKS, "loop_wall_ms_per_tick": wall_ms,
        "device_busy_ms_per_tick": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_ops_per_tick": sum(n for n, _ in per_kernel.values()) / PROFILE_TICKS,
        "top": [[k[:60], n / PROFILE_TICKS, us / 1e3 / PROFILE_TICKS] for k, (n, us) in top],
    })


def main() -> None:
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    device = resolve_device("cuda")  # raises where there is no card
    # The plain versions' float32 products in full float32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 1. Build, from the sources even where this checkout built them before.
    kernels.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    kernels.load()
    regs, entry = {}, None  # ptxas' resource line of each kernel
    for line in kernels.build.log.splitlines():
        named = re.search(r"entry function '_ZN3ctt\d+(\w+?_kernel)", line)
        if named:
            entry = named.group(1)
        elif "Used" in line:
            regs[entry or f"kernel {len(regs)}"] = line.split("ptxas info    : ")[-1]
    emit("build", {"seconds": time.perf_counter() - t0, "nvcc_seconds": kernels.build.seconds,
                   "library": kernels.library_path().name, "ptxas": regs})

    # 2-3. Each kernel against its plain version at the main path's shapes.
    ctrl = make_controller("cuda")
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    gen = torch.Generator(device=device).manual_seed(SEED)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=device))
    s0 = 0.05 * torch.randn(K, 4, generator=gen, device=device)
    Q = torch.clamp(0.3 * torch.randn(K, H, 1, generator=gen, device=device), -1.0, 1.0)
    k1 = compare("k1_cost_rollout", lambda: cost_rollout(model, s0, Q, pvec),
                 lambda: cost_rollout_plain(model, s0, Q, pvec))
    k1.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS), nbytes(s0, Q, pvec) + 4 * K))
    P = opt.interp.number_of_interpolation_inducing_points
    eps = opt.SQRTRHODTINV * torch.randn(P, 1, K, generator=gen, device=device)
    u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    k2_args = (model, s0[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix,
               opt.action_low, opt.action_high, opt.cc_weight, opt.R, opt.NU)
    k2 = compare("k2_mppi_cost", lambda: mppi_cost(*k2_args), lambda: mppi_cost_plain(*k2_args))
    k2.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS + MPPI_EXTRA_OPS),
                    nbytes(*k2_args[1:8]) + 4 * K))

    # 4-5. The MPPI paths, closed loop, each counted from 0.
    modular = make_controller("cuda", semi_fused=False)
    check(opt._uses_semi_fused() and not modular.optimizer._uses_semi_fused(),
          "the controllers did not take the expected MPPI paths")
    runs = {"semi_fused": counted_loop("slice_semi_fused", ctrl, TICKS, {"mppi_cost": TICKS},
                                       retarget_at=RETARGET_AT)}
    runs["modular"] = counted_loop("slice_modular", modular, MODULAR_TICKS,
                                   {"cost_rollout": MODULAR_TICKS})

    # 6. One update on the card against the same update on the CPU.
    check(float(ctrl.variable_parameters["target_position"]) == np.float32(NEW_TARGET),
          "the target change did not reach the controller")
    update_vs_cpu_mppi("update_vs_cpu", ctrl)

    # 7. K7 against its plain version at the gradient path's shapes.
    Qg = 2.0 * torch.rand(K, H, 1, generator=gen, device=device) - 1.0
    k7 = compare_grad(model, s0, Qg, pvec)
    k7.update(bound(K * H * (RK4_STEP_OPS + STAGE_OPS + RK4_VJP_OPS + STAGE_VJP_OPS),
                    nbytes(s0, Qg, pvec, Qg) + 4 * K))

    # 8-9. The gradient optimizers, closed loop.
    rpgd = make_controller("cuda", "rpgd-tf", RPGD_CONFIG)
    gradient = make_controller("cuda", "gradient-tf", GRADIENT_CONFIG)
    for c in (rpgd, gradient):
        check(ode.can_use_grad(c.optimizer), f"{c.optimizer.registered_name}: not on K7")
    runs["rpgd"] = counted_loop("slice_rpgd", rpgd, RPGD_TICKS,
                                {"cost_rollout": RPGD_TICKS, "grad_cost_rollout": 2 * RPGD_TICKS},
                                retarget_at=RETARGET_AT)
    runs["gradient"] = counted_loop("slice_gradient", gradient, GRADIENT_TICKS,
                                    {"cost_rollout": GRADIENT_TICKS,
                                     "grad_cost_rollout": 5 * GRADIENT_TICKS})

    # 10. One rpgd-tf update on the card against the same update on the CPU,
    # from the state the loop left, on a resample tick, with the same draw.
    update_vs_cpu_rpgd(rpgd)

    # 11-12. K11 and K8 over the committed MLP, at the learned paths' shapes.
    mlp = make_controller("cuda", spec=MLP_SPEC)
    nmodel, npack = neural.net_model(mlp.optimizer)
    nparams = mlp._assemble_params()
    net, npvec = nparams["dyn"]["net"], npack(nparams, torch.tensor([0.1], device=device))
    check("norm_in_mean" in net and "norm_out_mean" in net, "the committed MLP did not load")
    k11 = compare_neural(nmodel, s0, Q, npvec, net)
    k11.update(bound(K * H * (mlp_ops(net) + STAGE_OPS), nbytes(s0, Q, npvec, *leaves(net)) + 4 * K))
    k8 = compare_neural_grad(nmodel, s0, Qg, npvec, net)
    # One forward and the transposed layers: K8 re-runs the forward in its
    # backward, but a kernel that kept the activations would not have to.
    k8.update(bound(K * H * (mlp_ops(net) + mlp_vjp_ops(net) + STAGE_OPS + STAGE_VJP_OPS),
                    nbytes(s0, Qg, npvec, *leaves(net), Qg) + 4 * K))

    # 13. K13 over the committed GRU and over an LSTM of the same widths.
    k13 = compare_recurrent("k13_recurrent_cost_rollout_gru", GRU_SPEC, s0, Q, gen)
    compare_recurrent("k13_recurrent_cost_rollout_lstm", LSTM_SPEC, s0, Q, gen)

    # 14-16. The learned-dynamics paths, closed loop, each counted from 0.
    mlp_rpgd = make_controller("cuda", "rpgd-tf", RPGD_CONFIG, spec=MLP_SPEC)
    gru = make_controller("cuda", spec=GRU_SPEC)
    check(neural.can_use_cost(mlp.optimizer) and not mlp.optimizer._uses_semi_fused()
          and neural.can_use_grad(mlp_rpgd.optimizer) and neural.can_use_cost(gru.optimizer),
          "the learned-dynamics controllers did not take the network kernels")
    runs["mppi_mlp"] = counted_loop("slice_mppi_mlp", mlp, MLP_TICKS,
                                    {"neural_cost_rollout": MLP_TICKS}, retarget_at=RETARGET_AT,
                                    start=LEARNED_START)
    runs["rpgd_mlp"] = counted_loop("slice_rpgd_mlp", mlp_rpgd, MLP_RPGD_TICKS,
                                    {"neural_cost_rollout": MLP_RPGD_TICKS,
                                     "neural_grad_cost_rollout": 2 * MLP_RPGD_TICKS},
                                    retarget_at=RETARGET_AT, start=LEARNED_START)
    trace = []
    runs["mppi_gru"] = counted_loop("slice_mppi_gru", gru, GRU_TICKS,
                                    {"recurrent_cost_rollout": GRU_TICKS}, pole_check=False,
                                    trace=trace, start=LEARNED_START)
    gru_hidden_vs_replay(gru, trace)
    launches = {kernel: sum(r[kernel] for r in runs.values()) for kernel in COUNTED}

    # 17. One update on the card against the same update on the CPU, from
    # the state each loop left.
    update_vs_cpu_mppi("mlp_update_vs_cpu", mlp, MLP_SPEC)
    update_vs_cpu_mppi("gru_update_vs_cpu", gru, GRU_SPEC)
    update_vs_cpu_rpgd(mlp_rpgd, "rpgd_mlp_update_vs_cpu", MLP_SPEC)
    if "--starts" in sys.argv[1:]:
        start_sweep()
    if "--profile" in sys.argv[1:]:
        for name, c in (("mppi", ctrl), ("rpgd-tf", rpgd), ("gradient-tf", gradient),
                        ("mppi-mlp", mlp), ("rpgd-tf-mlp", mlp_rpgd), ("mppi-gru", gru)):
            profile_ticks(name, c)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "control_toolkit_tpu"))
    check(not foreign, f"the port's main path imported {foreign}")

    rows = (
        ("mppi_cost", "mppi_cost.cu", "ops/pallas_mppi.py:501", k2),
        ("cost_rollout", "cost_rollout.cu", "ops/pallas_rollout.py:34", k1),
        ("grad_cost_rollout", "grad_cost_rollout.cu", "ops/pallas_grad.py:335", k7),
        ("neural_cost_rollout", "neural_rollout.cu", "ops/pallas_neural.py:157", k11),
        ("recurrent_cost_rollout", "neural_rollout.cu", "ops/pallas_neural.py:452", k13),
        ("neural_grad_cost_rollout", "neural_grad_rollout.cu", "ops/pallas_grad.py:387", k8),
    )
    # No single PyTorch call computes a rollout's cost: library_ms is null.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"control_toolkit_tpu_torch/csrc/{source}",
         "replaces": f"control_toolkit_tpu/{replaces}", "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}
        for name, source, replaces, k in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
