"""K1 (cost_rollout over chip_smoke.py phase 2's operands) at K=2048 and
16384, H=50, and K6 (fused_cem_cols over phase 36's fleet operands) at
B=32 and 128 sessions of K=512, H=35, timed through their public wrappers
in the checkout given as the argument:

    python probes/k1_k6_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels, takes its chip_smoke.py's operands (the main path's
and the fleet's configurations) and prints one line, ``k1_k6_times:
{...}``, of CUDA-event milliseconds (chip_smoke.py's ``cuda_ms``), the
card and the built library.
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
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.fused_cem_cols import fused_cem_cols  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import ode  # noqa: E402

SIZES, SESSIONS = (2048, 16384), (32, 128)


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": str(ROOT), "card": card, "library": kernels.library_path().name}
    ctrl = cs.make_controller("cuda")
    model, pack = ode.rollout_model(ctrl.optimizer)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    s0 = 0.05 * torch.randn(cs.K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(cs.K, cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    for k in SIZES:
        s, q = s0[:k].contiguous(), Q[:k].contiguous()
        out[f"k1_{k}"] = cs.cuda_ms(lambda: cost_rollout(model, s, q, pvec), 50)
    fleet = cs.fleet_controller("cuda", "cem-tf", cs.FLEET_CEM_CONFIG, cs.FLEET_B)
    opt = fleet.optimizer
    B, K, Hf = cs.FLEET_B_MAX, opt.num_rollouts, opt.mpc_horizon
    fmodel, pvec_b, f0 = cs.fleet_operands(opt, B, gen)
    mue = torch.clamp(0.2 * torch.randn(B, Hf, 1, generator=gen, device=dev), -1.0, 1.0)
    std = torch.full((B, Hf, 1), 0.5, device=dev)
    seed_b = torch.randint(0, 2**31 - 1, (B,), generator=gen, dtype=torch.int32, device=dev)
    for b in SESSIONS:
        args = (fmodel, f0[:b], mue[:b], std[:b], pvec_b[:b], seed_b[:b], opt.action_low,
                opt.action_high, K)
        out[f"k6_b{b}"] = cs.cuda_ms(lambda: fused_cem_cols(*args), 50)
    print("k1_k6_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
