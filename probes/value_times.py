"""K1, K2, K4 and K7 timed through their public wrappers, and, where the
checkout has them, their value forms (K1's, K2's and K4's emit_terminal
forms, K7's value_spec form over chip_smoke.py's seeded V), in the
checkout given as the argument:

    python probes/value_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels from its sources (so that ptxas reports each kernel's
registers), takes its chip_smoke.py's operands (K1, K2, K7: the main
path's, K=16384, H=50; K4: the fleet's, B=32 and 128 sessions of K=512,
H=35) and prints one line, ``value_times: {...}``, of CUDA-event
milliseconds (chip_smoke.py's ``cuda_ms``), registers, the card and the
built library.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from control_toolkit_tpu_torch.ops import cost_rollout as k1  # noqa: E402
from control_toolkit_tpu_torch.ops import grad_cost_rollout as k7  # noqa: E402
from control_toolkit_tpu_torch.ops import kernels  # noqa: E402
from control_toolkit_tpu_torch.ops import mppi_cost as k2  # noqa: E402
from control_toolkit_tpu_torch.ops import mppi_cost_cols as k4  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import ode  # noqa: E402

REGISTERS = {"k1": ("cost_rollout_kernel", "Lb0E"), "k2": ("mppi_cost_kernel", ""),
             "k4": ("mppi_cost_cols_kernel", ""),
             "k7_forward": ("grad_cost_forward_kernel", "Lb0E"),
             "k7_adjoint": ("grad_cost_adjoint_kernel", "Lb0E"),
             "k1_emit": ("cost_rollout_emit_kernel", ""),
             "k2_emit": ("mppi_cost_emit_kernel", ""),
             "k4_emit": ("mppi_cost_cols_emit_kernel", ""),
             "k7_value_forward": ("grad_cost_forward_value_kernel", ""),
             "k7_value_adjoint": ("grad_cost_adjoint_value_kernel", "")}


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library_path().unlink(missing_ok=True)
    kernels.load()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": str(ROOT), "card": card, "library": kernels.library_path().name,
           "registers": {name: cs.ptxas_resources(*entry).get("registers")
                         for name, entry in REGISTERS.items()}}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ctrl = cs.make_controller("cuda")
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev))
    s0 = 0.05 * torch.randn(cs.K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(cs.K, cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    Qg = 2.0 * torch.rand(cs.K, cs.H, 1, generator=gen, device=dev) - 1.0
    P = opt.interp.number_of_interpolation_inducing_points
    eps = opt.SQRTRHODTINV * torch.randn(P, 1, cs.K, generator=gen, device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    a2 = (model, s0[0].contiguous(), u_nom, pvec, eps, opt.interp.matrix, opt.action_low,
          opt.action_high, opt.cc_weight, opt.R, opt.NU)
    runs = {"k1": lambda: k1.cost_rollout(model, s0, Q, pvec), "k2": lambda: k2.mppi_cost(*a2),
            "k7": lambda: k7.grad_cost_rollout(model, s0, Qg, pvec)}
    if hasattr(k1, "cost_rollout_emit"):
        ops = cs.seeded_value(dev)
        runs.update({"k1_emit": lambda: k1.cost_rollout_emit(model, s0, Q, pvec),
                     "k2_emit": lambda: k2.mppi_cost_emit(*a2),
                     "k7_value": lambda: k7.grad_cost_rollout_value(model, s0, Qg, pvec, ops)})
    fleet = cs.fleet_controller("cuda", "mppi", cs.FLEET_MPPI_CONFIG, cs.FLEET_B)
    fopt = fleet.optimizer
    fmodel, pvec_b, fs0 = cs.fleet_operands(fopt, cs.FLEET_B_MAX, gen)
    Pf, Kf, Hf = (fopt.interp.number_of_interpolation_inducing_points, fopt.num_rollouts,
                  fopt.mpc_horizon)
    fu = torch.clamp(0.2 * torch.randn(cs.FLEET_B_MAX, Hf, 1, generator=gen, device=dev),
                     -1.0, 1.0)
    fe = fopt.SQRTRHODTINV * torch.randn(cs.FLEET_B_MAX, Pf, 1, Kf, generator=gen, device=dev)
    fc = (fopt.interp.matrix, fopt.action_low, fopt.action_high, fopt.cc_weight, fopt.R,
          fopt.NU)
    for b in (cs.FLEET_B, cs.FLEET_B_MAX):
        a4 = (fmodel, fs0[:b], fu[:b], pvec_b[:b], fe[:b]) + fc
        runs[f"k4_b{b}"] = lambda a4=a4: k4.mppi_cost_cols(*a4)
        if hasattr(k4, "mppi_cost_cols_emit"):
            runs[f"k4_emit_b{b}"] = lambda a4=a4: k4.mppi_cost_cols_emit(*a4)
    out["ms"] = {name: cs.cuda_ms(fn, 50) for name, fn in runs.items()}
    print("value_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
