"""K14 (gp_cost_rollout over chip_smoke.py phase 20's operands: the
committed SGP_128's widths, its posterior weights drawn N(0, 1)) and K3's
pass 1 (fused_mppi_costs over phase 28's operands) at K=2048 and 16384,
H=50, timed through their public wrappers in the checkout given as the
argument:

    python probes/k14_k3_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels, takes its chip_smoke.py's operands and prints one
line, ``k14_k3_times: {...}``, of CUDA-event milliseconds (chip_smoke.py's
``cuda_ms``), the card and the built library.
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
from control_toolkit_tpu_torch.ops.gp_rollout import (  # noqa: E402
    flatten_gp_weights, gp_cost_rollout,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, ode  # noqa: E402

SIZES = (2048, 16384)


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
    s0 = 0.05 * torch.randn(cs.K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(cs.K, cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    ctrl = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.GP_SPEC)
    model, pack = gp.gp_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=dev))
    ops = flatten_gp_weights(cs.well_conditioned_gp(params["dyn"]["gp"]))
    for k in SIZES:
        s, q = s0[:k].contiguous(), Q[:k].contiguous()
        out[f"k14_{k}"] = cs.cuda_ms(lambda: gp_cost_rollout(model, s, q, pvec, ops), 50)
    fused = cs.make_controller("cuda", "mppi", cs.FUSED_MPPI_CONFIG)
    opt = fused.optimizer
    smodel, spack = ode.rollout_model(opt)
    spvec = spack(fused._assemble_params(), torch.tensor([0.1], device=dev))
    x0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    seed2 = torch.tensor([7654321, 0], dtype=torch.int32, device=dev)
    for k in SIZES:
        args = (smodel, x0, u_nom, spvec, seed2, opt.interp.matrix, opt.action_low,
                opt.action_high, opt.cc_weight, opt.R, opt.NU, opt.SQRTRHODTINV, k,
                min(k, DEFAULT_TILE_K))
        out[f"k3_pass1_{k}"] = cs.cuda_ms(lambda: fused_mppi_costs(*args), 50)
    print("k14_k3_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
