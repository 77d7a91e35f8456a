"""K12 and K9 over one plant other than cartpole with the residual MLP
inlined into the kernel, against the outlined call the library builds
(csrc/residual_core.cuh ``kInlineMlp``), in turns:

    python probes/inline_mlp_times.py <checkout root> [plant]

Copies the checkout (its sources, not its builds) to
``<checkout>/_checkout/inline_mlp`` with ``kInlineMlp`` true for the
plant (default: the pendulum), then, one process a build, in the order
outlined, inlined, inlined, outlined, times K12, K12-emit, K9 and
K9-value at chip_smoke.py's main path (K=16384, H=50) over phase 89's
operands (phase 18's seeded residual, the seeded V), each held against its
plain version.  A process builds its checkout's kernels unless their
library is built already.  Prints one line, ``inline_mlp_times: {...}``:
for each run, the build, each form's CUDA-event ms (chip_smoke.py's
``cuda_ms``) and largest error against its plain version, and each form's
blocks per SM, registers and spills (ptxas' where the process built the
library).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

TRAIT = ("template <>\nconstexpr bool kInlineMlp<CartpoleFastPlant> = true;\n")


def inlined_copy(root: Path, plant: str) -> Path:
    """The checkout's copy with kInlineMlp true for ``plant``'s struct."""
    dst = root / "_checkout" / "inline_mlp"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns(
        "_checkout", "_build", "chiprun_out", ".git", "__pycache__"))
    struct = "".join(w.capitalize() for w in plant.split("_")) + "Plant"
    core = dst / "control_toolkit_tpu_torch" / "csrc" / "residual_core.cuh"
    text = core.read_text()
    assert TRAIT in text, "kInlineMlp's cartpole entries moved"
    core.write_text(text.replace(TRAIT, TRAIT + f"template <>\nconstexpr bool "
                                 f"kInlineMlp<{struct}> = true;\n"))
    return dst


def one(root: Path, plant: str) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from control_toolkit_tpu_torch.ops import kernels
    from control_toolkit_tpu_torch.ops import residual_grad_cost_rollout as k9
    from control_toolkit_tpu_torch.ops import residual_rollout as k12
    from control_toolkit_tpu_torch.optimizers.kernel_families import residual

    kernels.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 89)
    ctrl = cs.plant_res_controller(plant, "mppi", cs.RES_MPPI_CONFIG)
    model, pack = residual.residual_model(ctrl.optimizer)
    S, U = kernels.PLANT_DIMS[plant]
    lo, hi = ctrl.optimizer.action_low, ctrl.optimizer.action_high
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    params = ctrl._assemble_params()
    net, pvec = params["dyn"]["res"], pack(params, mid + 0.1 * half)
    vnet = cs.plant_value_net(plant, dev)
    vops = cs.plant_value_ops(vnet)
    s0 = cs.plant_states(plant, cs.K, gen)
    Q = torch.clamp(mid + half * (0.5 * torch.randn(cs.K, cs.H, U, generator=gen, device=dev)),
                    lo, hi)
    Qg = lo + (hi - lo) * torch.rand(cs.K, cs.H, U, generator=gen, device=dev)
    forms = {
        "k12": (lambda: k12.residual_cost_rollout(model, s0, Q, pvec, net),
                lambda: (k12.residual_cost_rollout_plain(model, s0, Q, pvec, net),)),
        "k12_emit": (lambda: k12.residual_cost_rollout_emit(model, s0, Q, pvec, net),
                     lambda: k12.residual_cost_rollout_emit_plain(model, s0, Q, pvec, net)),
        "k9": (lambda: k9.residual_grad_cost_rollout(model, s0, Qg, pvec, net),
               lambda: k9.residual_grad_cost_rollout_plain(model, s0, Qg, pvec, net)),
        "k9_value": (lambda: k9.residual_grad_cost_rollout_value(model, s0, Qg, pvec, net, vops),
                     lambda: k9.residual_grad_cost_rollout_plain(model, s0, Qg, pvec, net,
                                                                 vops)),
    }
    resources = cs.forms_resources(plant, model.net_args(net)[0], vnet)
    out = {"checkout": str(root), "library": kernels.library_path().name,
           "built_here_s": kernels.build.seconds if kernels.build.log else None}
    for name, (kernel, plain) in forms.items():
        got = kernel()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        out[name] = {"ms": cs.cuda_ms(kernel, 20),
                     "max_abs_err": max(float((g - r).abs().max()) for g, r in zip(got, ref)),
                     **resources[name]}
    return out


def main() -> None:
    if sys.argv[1] == "--one":
        print(json.dumps(one(Path(sys.argv[2]).resolve(), sys.argv[3])), flush=True)
        return
    root = Path(sys.argv[1]).resolve()
    plant = sys.argv[2] if len(sys.argv) > 2 else "pendulum"
    inlined = inlined_copy(root, plant)
    runs = []
    for label, where in (("outlined", root), ("inlined", inlined), ("inlined", inlined),
                         ("outlined", root)):
        done = subprocess.run([sys.executable, __file__, "--one", str(where), plant],
                              capture_output=True, text=True, cwd=where)
        if done.returncode != 0:
            raise SystemExit(f"{label} run failed:\n{done.stderr[-4000:]}")
        runs.append({"build": label, **json.loads(done.stdout.strip().splitlines()[-1])})
    print("inline_mlp_times: " + json.dumps({"plant": plant, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
