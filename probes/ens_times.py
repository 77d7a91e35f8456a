"""K11 (neural_cost_rollout) and K8 (neural_grad_cost_rollout) over the
committed mlp-64-64, timed through their public wrappers at the main path's
K=16384, H=50, with ptxas' registers and spills for each, and, in a
checkout that has them, their member-block forms over the committed
four-member mlp-32-32 ensemble at the same shapes with theirs, in the
checkout given as the argument:

    python probes/ens_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels from its sources (the library deleted first, so that
ptxas reports), takes its chip_smoke.py's operands (seed 0) and prints one
line, ``ens_times: {...}``, of CUDA-event milliseconds (chip_smoke.py's
``cuda_ms``), the resources and the card.
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
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (  # noqa: E402
    neural_grad_cost_rollout,
)
from control_toolkit_tpu_torch.ops.neural_rollout import neural_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import neural  # noqa: E402

KERNELS = {"k11": "neural_cost_rollout_kernel", "k8": "neural_grad_cost_rollout_kernel",
           "k11_ens": "neural_cost_rollout_ens_kernel",
           "k8_ens": "neural_grad_cost_rollout_ens_kernel"}


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library_path().unlink(missing_ok=True)
    kernels.load()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    s0 = 0.05 * torch.randn(cs.K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(cs.K, cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    Qg = 2.0 * torch.rand(cs.K, cs.H, 1, generator=gen, device=dev) - 1.0
    u_prev = torch.tensor([0.1], device=dev)
    out = {"root": str(ROOT), "card": card,
           "resources": {k: cs.ptxas_resources(v) for k, v in KERNELS.items()}}

    mlp = cs.make_controller("cuda", spec=cs.MLP_SPEC)
    model, pack = neural.net_model(mlp.optimizer)
    params = mlp._assemble_params()
    net, pvec = params["dyn"]["net"], pack(params, u_prev)
    out["k11"] = cs.cuda_ms(lambda: neural_cost_rollout(model, s0, Q, pvec, net), 50)
    out["k8"] = cs.cuda_ms(lambda: neural_grad_cost_rollout(model, s0, Qg, pvec, net), 20)
    if hasattr(cs, "ENS_SPEC"):  # a checkout with the member-block forms
        from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (
            neural_grad_cost_rollout_ens,
        )
        from control_toolkit_tpu_torch.ops.neural_rollout import neural_cost_rollout_ens
        from control_toolkit_tpu_torch.optimizers.kernel_families import ensemble

        ens = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.ENS_SPEC)
        emodel, epack = ensemble.net_model(ens.optimizer)
        eparams = ens._assemble_params()
        enet, epvec = eparams["dyn"]["net"], epack(eparams, u_prev)
        out["k11_ens"] = cs.cuda_ms(lambda: neural_cost_rollout_ens(emodel, s0, Q, epvec, enet),
                                    50)
        out["k8_ens"] = cs.cuda_ms(
            lambda: neural_grad_cost_rollout_ens(emodel, s0, Qg, epvec, enet), 20)
        # The single-net kernels over member 0 at the same shapes.
        one = cs.member_net(enet, 0)
        out["k11_member0"] = cs.cuda_ms(lambda: neural_cost_rollout(emodel, s0, Q, epvec, one), 50)
        out["k8_member0"] = cs.cuda_ms(
            lambda: neural_grad_cost_rollout(emodel, s0, Qg, epvec, one), 20)
    print("ens_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
