"""Drive the torch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the flagship controller: the "mpc" controller over the
"mppi" optimizer, the rk4 "ODE" predictor on the cartpole plant and the
cartpole/default cost, closed-loop against CartpoleEnv at K=16384
rollouts, H=50, inducing period 10, seed 0.  Phases, each printing one
line of its numbers:

1. build the CUDA kernels from control_toolkit_tpu_torch/csrc with nvcc;
2. K1 (cost_rollout) and 3. K2 (mppi_cost) against their plain PyTorch
   versions on the card, at the main path's shapes, with CUDA-event times;
4. 200 closed-loop ticks on the default (semi-fused, K2) path, with a
   target change midway that must not rebuild anything;
5. 50 ticks with semi_fused=False (the modular path, K1);
6. one step of the card's update against the same update on the CPU.

No phase catches its own failure: any mismatch raises and the exit code is
not 0.  Without a card it raises before printing any result.  The last
line is the JSON result; the line before it lists the kernels.
Imports nothing of JAX and nothing of the JAX package (it passes every
config explicitly, so no config file is read).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from control_toolkit_tpu_torch.controllers.mpc import MPCController
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv
from control_toolkit_tpu_torch.ops import kernels
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout, cost_rollout_plain
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost, mppi_cost_plain
from control_toolkit_tpu_torch.optimizers.kernel_families import ode
from control_toolkit_tpu_torch.utils.convert import mppi_state_from_numpy
from control_toolkit_tpu_torch.utils.device import resolve_device

K, H, PERIOD, SEED, DT = 16384, 50, 10, 0, 0.02
TICKS, MODULAR_TICKS, RETARGET_AT, NEW_TARGET = 200, 50, 100, 0.1
# config_cost_function.yml, cartpole/default.
COST_WEIGHTS = {"dd_weight": 120.0, "ep_weight": 10000.0, "ekp_weight": 10.0,
                "cc_weight": 1.0, "ccrc_weight": 1.0, "R": 1.0}
OPTIMIZER_CONFIG = {"seed": SEED, "mpc_timestep": DT, "mpc_horizon": H, "num_rollouts": K,
                    "cc_weight": 1.0, "R": 1.0, "LBD": 100.0, "NU": 1000.0,
                    "SQRTRHOINV": 0.03, "period_interpolation_inducing_points": PERIOD}
LIMITS = (np.array([-1.0], np.float32), np.array([1.0], np.float32))
# Kernel vs plain version on the same card tensors: nvcc contracts a*b+c
# into FMA, the plain version's separate ops do not; from states near
# upright the 50-step rollouts stay within float32 rounding of each other.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-3)
# One full update on the card vs on the CPU (plain versions): costs agree
# to the kernel tolerance, the softmax-weighted plan far tighter.
UNOM_ATOL = 1e-4


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


def make_controller(device: str, **extra) -> MPCController:
    ctrl = MPCController("cartpole", LIMITS, {"target_position": 0.0},
                         config={"optimizer": "mppi", "controller_logging": False,
                                 "device": device})
    ctrl.configure(optimizer_name="mppi", optimizer_config={**OPTIMIZER_CONFIG, **extra},
                   cost_function_config=COST_WEIGHTS)
    return ctrl


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
    regs = [line.split("ptxas info    : ")[-1] for line in kernels.build.log.splitlines()
            if "Used" in line]
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

    # 4-5. The main path, closed loop; only these launches are counted.
    modular = make_controller("cuda", semi_fused=False)
    check(opt._uses_semi_fused() and not modular.optimizer._uses_semi_fused(),
          "the controllers did not take the expected MPPI paths")
    cost_rollout.launches = 0
    mppi_cost.launches = 0
    closed_loop("slice_semi_fused", ctrl, TICKS, retarget_at=RETARGET_AT)
    check(mppi_cost.launches == TICKS and cost_rollout.launches == 0,
          f"semi-fused loop: {mppi_cost.launches} K2 / {cost_rollout.launches} K1 launches")
    closed_loop("slice_modular", modular, MODULAR_TICKS)
    check(cost_rollout.launches == MODULAR_TICKS and mppi_cost.launches == TICKS,
          f"modular loop: {cost_rollout.launches} K1 / {mppi_cost.launches} K2 launches")
    launches = {"mppi_cost": mppi_cost.launches, "cost_rollout": cost_rollout.launches}

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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
