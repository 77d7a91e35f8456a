"""K2 (mppi_cost over chip_smoke.py phase 3's operands) at K=2048 and
16384, H=50; K4 (mppi_cost_cols over phase 35's operands) at B=32 and 128
sessions of K=512, H=35; and K3's pass 1 (fused_mppi_costs over phase 28's
operands), the kernel that shares their body, at K=16384 — timed through
their public wrappers in the checkout given as the argument:

    python probes/k2_k4_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels, takes its chip_smoke.py's operands and prints one
line, ``k2_k4_times: {...}``, of CUDA-event milliseconds (chip_smoke.py's
``cuda_ms``), the card and the built library.  The bracket-table form
that PERF.md compares with K2's and K4's walk is
``probes/k2_k4_bracket_table.diff``, applied to a copy of a checkout.
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
from control_toolkit_tpu_torch.ops import kernels  # noqa: E402
from control_toolkit_tpu_torch.ops.counter_prng import DEFAULT_TILE_K  # noqa: E402
from control_toolkit_tpu_torch.ops.fused_mppi import fused_mppi_costs  # noqa: E402
from control_toolkit_tpu_torch.ops.mppi_cost import mppi_cost  # noqa: E402
from control_toolkit_tpu_torch.ops.mppi_cost_cols import mppi_cost_cols  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import ode  # noqa: E402

K2_SIZES, K4_SESSIONS = (2048, 16384), (32, 128)


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": str(ROOT), "card": card, "library": kernels.library_path().name}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ctrl = cs.make_controller("cuda")
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev))
    P = opt.interp.number_of_interpolation_inducing_points
    x0 = 0.05 * torch.randn(4, generator=gen, device=dev)
    eps = opt.SQRTRHODTINV * torch.randn(P, 1, cs.K, generator=gen, device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    consts = (opt.interp.matrix, opt.action_low, opt.action_high, opt.cc_weight, opt.R, opt.NU)
    for k in K2_SIZES:
        e = eps[:, :, :k].contiguous()
        out[f"k2_{k}"] = cs.cuda_ms(lambda: mppi_cost(model, x0, u_nom, pvec, e, *consts), 50)
    seed2 = torch.tensor([7654321, 0], dtype=torch.int32, device=dev)
    s3 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    args = (model, s3, u_nom, pvec, seed2, *consts, opt.SQRTRHODTINV, cs.K, DEFAULT_TILE_K)
    out[f"k3_pass1_{cs.K}"] = cs.cuda_ms(lambda: fused_mppi_costs(*args), 50)
    fleet = cs.fleet_controller("cuda", "mppi", cs.FLEET_MPPI_CONFIG, cs.FLEET_B)
    fopt = fleet.optimizer
    fmodel, pvec_b, s0 = cs.fleet_operands(fopt, cs.FLEET_B_MAX, gen)
    Pf, Kf, Hf = fopt.interp.number_of_interpolation_inducing_points, fopt.num_rollouts, \
        fopt.mpc_horizon
    un = torch.clamp(0.2 * torch.randn(cs.FLEET_B_MAX, Hf, 1, generator=gen, device=dev),
                     -1.0, 1.0)
    fe = fopt.SQRTRHODTINV * torch.randn(cs.FLEET_B_MAX, Pf, 1, Kf, generator=gen, device=dev)
    fconsts = (fopt.interp.matrix, fopt.action_low, fopt.action_high, fopt.cc_weight, fopt.R,
               fopt.NU)
    for b in K4_SESSIONS:
        out[f"k4_b{b}"] = cs.cuda_ms(
            lambda: mppi_cost_cols(fmodel, s0[:b], un[:b], pvec_b[:b], fe[:b], *fconsts), 50)
    print("k2_k4_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
