"""K12 (residual_cost_rollout with chip_smoke.py phase 18's nonzero
residual) and K5 (fused_cem_costs over phase 27's operands) timed through
their public wrappers at K=2048 and 16384, H=50, beside K1
(cost_rollout, K5's yardstick) at K=16384, in the checkout given as the
argument:

    python probes/k12_k5_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels, takes its chip_smoke.py's operands (the main path's
configuration, seed 0) and prints one line, ``k12_k5_times: {...}``, of
CUDA-event milliseconds (chip_smoke.py's ``cuda_ms``), the card and the
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
from control_toolkit_tpu_torch.ops import fused_cem, kernels, residual_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.cost_rollout import cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.counter_prng import DEFAULT_TILE_K  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import ode, residual  # noqa: E402

SIZES = (2048, 16384)


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    s0 = 0.05 * torch.randn(cs.K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(cs.K, cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    out = {"root": str(ROOT), "card": card, "library": kernels.library_path().name}
    ctrl = cs.residual_controller("rpgd-tf", cs.RES_RPGD_CONFIG)
    model, pack = residual.residual_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    net, pvec = params["dyn"]["res"], pack(params, torch.tensor([0.1], device=dev))
    for k in SIZES:
        s, q = s0[:k].contiguous(), Q[:k].contiguous()
        out[f"k12_{k}"] = cs.cuda_ms(
            lambda: residual_rollout.residual_cost_rollout(model, s, q, pvec, net), 50)
    cem = cs.make_controller("cuda", "cem-tf", {**cs.CEM_CONFIG, "fully_fused": True})
    smodel, spack = ode.rollout_model(cem.optimizer)
    spvec = spack(cem._assemble_params(), torch.tensor([0.1], device=dev))
    low, high = cem.optimizer.action_low, cem.optimizer.action_high
    c0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    mue = torch.clamp(0.2 * torch.randn(cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    std = torch.full((cs.H, 1), 0.5, device=dev)
    seed2 = torch.tensor([1234567, 0], dtype=torch.int32, device=dev)
    for k in SIZES:
        args = (smodel, c0, mue, std, spvec, seed2, low, high, k, min(k, DEFAULT_TILE_K))
        out[f"k5_{k}"] = cs.cuda_ms(lambda: fused_cem.fused_cem_costs(*args), 50)
    out["k1_16384"] = cs.cuda_ms(lambda: cost_rollout(smodel, s0, Q, spvec), 50)
    print("k12_k5_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
