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

    python3 chip_smoke.py --profile

adds, after phase 10, a ``torch.profiler`` trace of 20 ticks (after 30
warm-up ticks) of each main path, printing per tick the device busy time,
the number of device operations and the costliest device kernels.

Every kernel's launch count is set to 0 just before each closed loop and
read just after it; launches made to compare a kernel with its plain
version are not counted.  No phase catches its own failure: any mismatch
raises and the exit code is not 0.  Without a card it raises before
printing any result.  The last line is the JSON result; the line before it
lists the kernels.
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
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.common import elite_indices
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.grad_cost_rollout import (
    grad_cost_rollout, grad_cost_rollout_plain,
)
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost, mppi_cost_plain
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
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
           "grad_cost_rollout": grad_cost_rollout}


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


def compare(name: str, kernel_fn, plain_fn) -> dict:
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    numbers = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp_min(1e-6)).max()),
        "finite": bool(torch.isfinite(got).all()),
        "ms": cuda_ms(kernel_fn, 50),
        "plain_ms": cuda_ms(plain_fn, 3),
    }
    emit(name, numbers)
    check(numbers["finite"] and got.shape == (K,), f"{name}: bad output")
    check(torch.allclose(got, ref, **KERNEL_TOL), f"{name}: kernel disagrees with plain {numbers}")
    return numbers


def close(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol_frac: float) -> bool:
    """allclose with the absolute bound a fraction of ref's largest entry."""
    return torch.allclose(got, ref, rtol=rtol, atol=atol_frac * float(ref.abs().max()))


def max_errors(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got - ref).abs()
    return float(err.max()), float((err / ref.abs().clamp_min(1e-6)).max())


def make_controller(device: str, optimizer: str = "mppi", config=None, **extra) -> MPCController:
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": optimizer, "controller_logging": False,
                                 "device": device})
    ctrl.configure(optimizer_name=optimizer,
                   optimizer_config={**(config or OPTIMIZER_CONFIG), **extra},
                   cost_function_config=COST_WEIGHTS)
    return ctrl


def counted_loop(name: str, ctrl: MPCController, ticks: int, retarget_at=None) -> dict:
    """A closed loop with every kernel's launch count set to 0 just before
    it; returns the counts read just after it."""
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    closed_loop(name, ctrl, ticks, retarget_at=retarget_at)
    return {kernel: wrapper.launches for kernel, wrapper in COUNTED.items()}


def closed_loop(name: str, ctrl: MPCController, ticks: int, retarget_at=None) -> dict:
    env = CartpoleEnv(batch_size=1, dt=DT, seed=SEED)
    s, _ = env.reset()
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
        s, *_ = env.step(u)
        max_angle = max(max_angle, abs(float(s[0, 2])))
        check(max_angle < 0.5, f"{name}: tick {t}: the pole fell, state {s[0]}")
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


def update_vs_cpu_rpgd(ctrl: MPCController) -> None:
    """Phase 10: one rpgd-tf update on the card and on the CPU (the plain
    versions) from the card's state, on a resample tick, with one draw."""
    opt = ctrl.optimizer
    state = opt.opt_state
    check(state.count % opt.resamp_per == 0, f"tick {state.count} is not a resample tick")
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=opt.device)
    draw = opt.sample_resample(state)
    u, new, diag = opt.update(state, s_now, ctrl._assemble_params(), draw)

    cpu = make_controller("cpu", "rpgd-tf", RPGD_CONFIG)
    cpu.update_attributes({"target_position": NEW_TARGET})
    host = [t.cpu().numpy() for t in (state.Q, state.adam.m, state.adam.v,
                                      state.trajectory_ages, state.u_prev)]
    cpu_state = rpgd_state_from_numpy(host[0], host[1], host[2], state.adam.step, host[3],
                                      state.count, host[4], torch.Generator())
    uc, new_c, cdiag = cpu.optimizer.update(cpu_state, s_now.cpu(), cpu._assemble_params(),
                                            draw.cpu())

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
    emit("rpgd_update_vs_cpu", numbers)
    for k, (a, b) in pairs.items():
        check(close(a, b, UPDATE_RTOL, UPDATE_ATOL_FRAC),
              f"rpgd update: {k} on the card differs from the CPU {numbers}")
    check(not same_best or close(u.cpu(), uc, UPDATE_RTOL, UPDATE_ATOL_FRAC),
          f"rpgd update: u differs {numbers}")


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
    P = opt.interp.number_of_interpolation_inducing_points
    eps = opt.SQRTRHODTINV * torch.randn(P, 1, K, generator=gen, device=device)
    u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=device), -1.0, 1.0)
    k2_args = (model, s0[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix,
               opt.action_low, opt.action_high, opt.cc_weight, opt.R, opt.NU)
    k2 = compare("k2_mppi_cost", lambda: mppi_cost(*k2_args), lambda: mppi_cost_plain(*k2_args))

    # 4-5. The MPPI paths, closed loop, each counted from 0.
    modular = make_controller("cuda", semi_fused=False)
    check(opt._uses_semi_fused() and not modular.optimizer._uses_semi_fused(),
          "the controllers did not take the expected MPPI paths")
    runs = {"semi_fused": counted_loop("slice_semi_fused", ctrl, TICKS, retarget_at=RETARGET_AT)}
    check(runs["semi_fused"] == {"cost_rollout": 0, "mppi_cost": TICKS, "grad_cost_rollout": 0},
          f"semi-fused loop launches {runs['semi_fused']}")
    runs["modular"] = counted_loop("slice_modular", modular, MODULAR_TICKS)
    check(runs["modular"] == {"cost_rollout": MODULAR_TICKS, "mppi_cost": 0,
                              "grad_cost_rollout": 0},
          f"modular loop launches {runs['modular']}")

    # 6. One update on the card against the same update on the CPU.
    check(float(ctrl.variable_parameters["target_position"]) == np.float32(NEW_TARGET),
          "the target change did not reach the controller")
    state = opt.opt_state
    s_now = torch.tensor([[0.02, -0.1, 0.05, 0.1]], device=device)
    noise = opt.sample_noise(state)
    _, _, diag = opt.update(state, s_now, ctrl._assemble_params(), noise)
    cpu = make_controller("cpu")
    cpu.update_attributes({"target_position": NEW_TARGET})
    cpu_state = mppi_state_from_numpy(state.u_nom.cpu().numpy(), state.u_prev.cpu().numpy(),
                                      torch.Generator())
    _, _, cpu_diag = cpu.optimizer.update(cpu_state, s_now.cpu(), cpu._assemble_params(),
                                          noise.cpu())
    unom_err = float((diag["u_nom"].cpu() - cpu_diag["u_nom"]).abs().max())
    cost_err = float((diag["J_logged"].cpu() - cpu_diag["J_logged"]).abs().max())
    emit("update_vs_cpu", {"u_nom_max_abs_err": unom_err, "cost_max_abs_err": cost_err})
    check(unom_err <= UNOM_ATOL, f"card update differs from the CPU update by {unom_err}")

    # 7. K7 against its plain version at the gradient path's shapes.
    Qg = 2.0 * torch.rand(K, H, 1, generator=gen, device=device) - 1.0
    k7 = compare_grad(model, s0, Qg, pvec)

    # 8-9. The gradient optimizers, closed loop.
    rpgd = make_controller("cuda", "rpgd-tf", RPGD_CONFIG)
    gradient = make_controller("cuda", "gradient-tf", GRADIENT_CONFIG)
    for c in (rpgd, gradient):
        check(ode.can_use_grad(c.optimizer), f"{c.optimizer.registered_name}: not on K7")
    runs["rpgd"] = counted_loop("slice_rpgd", rpgd, RPGD_TICKS, retarget_at=RETARGET_AT)
    check(runs["rpgd"] == {"cost_rollout": RPGD_TICKS, "mppi_cost": 0,
                           "grad_cost_rollout": 2 * RPGD_TICKS},
          f"rpgd loop launches {runs['rpgd']}")
    runs["gradient"] = counted_loop("slice_gradient", gradient, GRADIENT_TICKS)
    check(runs["gradient"] == {"cost_rollout": GRADIENT_TICKS, "mppi_cost": 0,
                               "grad_cost_rollout": 5 * GRADIENT_TICKS},
          f"gradient-tf loop launches {runs['gradient']}")
    launches = {kernel: sum(r[kernel] for r in runs.values()) for kernel in COUNTED}

    # 10. One rpgd-tf update on the card against the same update on the CPU,
    # from the state the loop left, on a resample tick, with the same draw.
    update_vs_cpu_rpgd(rpgd)
    if "--profile" in sys.argv[1:]:
        for name, c in (("mppi", ctrl), ("rpgd-tf", rpgd), ("gradient-tf", gradient)):
            profile_ticks(name, c)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "control_toolkit_tpu"))
    check(not foreign, f"the port's main path imported {foreign}")

    print(json.dumps({"kernels": [
        {"name": "mppi_cost", "route": "cuda",
         "source": "control_toolkit_tpu_torch/csrc/mppi_cost.cu",
         "replaces": "control_toolkit_tpu/ops/pallas_mppi.py:501",
         "launches": launches["mppi_cost"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
        {"name": "cost_rollout", "route": "cuda",
         "source": "control_toolkit_tpu_torch/csrc/cost_rollout.cu",
         "replaces": "control_toolkit_tpu/ops/pallas_rollout.py:34",
         "launches": launches["cost_rollout"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "grad_cost_rollout", "route": "cuda",
         "source": "control_toolkit_tpu_torch/csrc/grad_cost_rollout.cu",
         "replaces": "control_toolkit_tpu/ops/pallas_grad.py:335",
         "launches": launches["grad_cost_rollout"], "max_abs_err": k7["max_abs_err"],
         "ms": k7["ms"], "plain_ms": k7["plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
