"""K10 (gp_grad_cost_rollout over the committed SGP_128) and K11
(neural_cost_rollout over the committed mlp-64-64) timed through their
public wrappers at K=2048 and 16384, H=50, in the checkout given as the
argument:

    python probes/k10_k11_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels, takes its chip_smoke.py's operands (the main path's
configuration, seed 0) and prints one line, ``k10_k11_times: {...}``, of
CUDA-event milliseconds (chip_smoke.py's ``cuda_ms``) and the card.  In a
checkout whose wrappers take the split's width (K10's lanes a rollout,
K11's warps a group), it also times each width at K=16384.
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
from control_toolkit_tpu_torch.ops import gp_grad_cost_rollout as gp_grad  # noqa: E402
from control_toolkit_tpu_torch.ops import kernels, neural_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import gp_grad_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.gp_rollout import flatten_gp_weights  # noqa: E402
from control_toolkit_tpu_torch.ops.neural_rollout import neural_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import gp, neural  # noqa: E402

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
    Qg = 2.0 * torch.rand(cs.K, cs.H, 1, generator=gen, device=dev) - 1.0
    out = {"root": str(ROOT), "card": card}
    ctrl = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.GP_SPEC)
    model, pack = gp.gp_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    pvec = pack(params, torch.tensor([0.1], device=dev))
    ops = flatten_gp_weights(params["dyn"]["gp"])
    for k in SIZES:
        s, q = s0[:k].contiguous(), Qg[:k].contiguous()
        out[f"k10_{k}"] = cs.cuda_ms(lambda: gp_grad_cost_rollout(model, s, q, pvec, ops), 20)
    lanes_fn = getattr(gp_grad, "gp_grad_cost_rollout_lanes", None)
    for lanes in (4, 8, 16, 32) if lanes_fn else ():
        out[f"k10_lanes{lanes}"] = cs.cuda_ms(lambda: lanes_fn(model, s0, Qg, pvec, ops, lanes), 20)
    ctrl = cs.make_controller("cuda", spec=cs.MLP_SPEC)
    model, pack = neural.net_model(ctrl.optimizer)
    params = ctrl._assemble_params()
    pvec, net = pack(params, torch.tensor([0.1], device=dev)), params["dyn"]["net"]
    for k in SIZES:
        s, q = s0[:k].contiguous(), Q[:k].contiguous()
        out[f"k11_{k}"] = cs.cuda_ms(lambda: neural_cost_rollout(model, s, q, pvec, net), 50)
    warps_fn = getattr(neural_rollout, "neural_cost_rollout_warps", None)
    for warps in (1, 2, 4) if warps_fn else ():
        out[f"k11_warps{warps}"] = cs.cuda_ms(lambda: warps_fn(model, s0, Q, pvec, net, warps), 50)
    print("k10_k11_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
