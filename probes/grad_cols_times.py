"""The single-session kernels that took a session-row form for the gradient
fleets, K1 (cost_rollout), K7 (grad_cost_rollout), K8
(neural_grad_cost_rollout, the committed mlp-64-64), K9
(residual_grad_cost_rollout, chip_smoke.py's seeded residual) and K10
(gp_grad_cost_rollout, a well-conditioned GP of the committed one's
widths), timed through their public wrappers at the main path's K=16384,
H=50, with ptxas' registers and spills for each (and, in a checkout that
has them, K1's and K7's session-row forms at chip_smoke.py's
GRAD_COLS_SHAPES with theirs), in the checkout given as the argument:

    python probes/grad_cols_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels from its sources (the library deleted first, so that
ptxas reports), takes its chip_smoke.py's operands (seed 0) and prints one
line, ``grad_cols_times: {...}``, of CUDA-event milliseconds
(chip_smoke.py's ``cuda_ms``), the resources and the card.
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
from control_toolkit_tpu_torch.ops.gp_grad_cost_rollout import gp_grad_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.gp_rollout import flatten_gp_weights  # noqa: E402
from control_toolkit_tpu_torch.ops.grad_cost_rollout import grad_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.neural_grad_cost_rollout import (  # noqa: E402
    neural_grad_cost_rollout,
)
from control_toolkit_tpu_torch.ops.residual_grad_cost_rollout import (  # noqa: E402
    residual_grad_cost_rollout,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import (  # noqa: E402
    gp, neural, ode, residual,
)

# K1's and K7's single-session instance where they have one (Rows false).
ONE = getattr(cs, "SINGLE", "")
KERNELS = {"k1": ("cost_rollout_kernel", ONE), "k7_forward": ("grad_cost_forward_kernel", ONE),
           "k7_adjoint": ("grad_cost_adjoint_kernel", ONE),
           "k8": ("neural_grad_cost_rollout_kernel", ""),
           "k9": ("residual_grad_cost_rollout_kernel", ""),
           "k10": ("gp_grad_cost_rollout_kernel", "Li4E")}


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
           "resources": {k: cs.ptxas_resources(*v) for k, v in KERNELS.items()}}

    ctrl = cs.make_controller("cuda")
    model, pack = ode.rollout_model(ctrl.optimizer)
    pvec = pack(ctrl._assemble_params(), u_prev)
    out["k1"] = cs.cuda_ms(lambda: cost_rollout(model, s0, Q, pvec), 50)
    out["k7"] = cs.cuda_ms(lambda: grad_cost_rollout(model, s0, Qg, pvec), 50)

    mlp = cs.make_controller("cuda", spec=cs.MLP_SPEC)
    nmodel, npack = neural.net_model(mlp.optimizer)
    nparams = mlp._assemble_params()
    net, npvec = nparams["dyn"]["net"], npack(nparams, u_prev)
    out["k8"] = cs.cuda_ms(lambda: neural_grad_cost_rollout(nmodel, s0, Qg, npvec, net), 20)

    res = cs.residual_controller("rpgd-tf", cs.RES_RPGD_CONFIG)
    rmodel, rpack = residual.residual_model(res.optimizer)
    rparams = res._assemble_params()
    rnet, rpvec = rparams["dyn"]["res"], rpack(rparams, u_prev)
    out["k9"] = cs.cuda_ms(lambda: residual_grad_cost_rollout(rmodel, s0, Qg, rpvec, rnet), 20)

    gctrl = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.GP_SPEC)
    gmodel, gpack = gp.gp_model(gctrl.optimizer)
    gparams = gctrl._assemble_params()
    wops = flatten_gp_weights(cs.well_conditioned_gp(gparams["dyn"]["gp"]))
    gpvec = gpack(gparams, u_prev)
    out["k10"] = cs.cuda_ms(lambda: gp_grad_cost_rollout(gmodel, s0, Qg, gpvec, wops), 20)
    if hasattr(cs, "grad_cols_operands"):  # a checkout with the session-row forms
        fleet = cs.grad_fleet("cuda", "rpgd_ode")
        for form in ("k1", "k7"):
            for B, ks in cs.GRAD_COLS_SHAPES:
                args = cs.grad_cols_operands(form, fleet, B, ks, gen)
                out[f"{form}_cols_B{B}_K{ks}"] = cs.cuda_ms(
                    lambda: cs.GRAD_COLS[form][0](*args), 50)
        out["rows_resources"] = {k: cs.ptxas_resources(v[0], cs.ROWS_FORM)
                                 for k, v in KERNELS.items() if v[1] == ONE and ONE}
    print("grad_cols_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
