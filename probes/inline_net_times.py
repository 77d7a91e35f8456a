"""K11, K13 and K8 over one cost other than cartpole's with the network's
step (K8: the MLP's step and its VJP) inlined into the kernel, against the
outlined calls the library builds (csrc/neural_core.cuh ``kInlineNet``), in
turns:

    python probes/inline_net_times.py <checkout root> [plant]

Copies the checkout (its sources, not its builds) to
``<checkout>/_checkout/inline_net`` with ``kInlineNet`` true for the
plant's cost (default: the pendulum's), then, one process a build, in the
order outlined, inlined, inlined, outlined, times K11, K11-emit, K13-GRU,
K13-LSTM and K8 at chip_smoke.py's main path (K=16384, H=50) over phase 92's
operands (the seeded mlp-64-64, GRU and LSTM 32-32 at the cost's widths),
each held against its plain version.  A process builds its checkout's
kernels unless their library is built already.  Prints one line,
``inline_net_times: {...}``: for each run, the build, each form's
CUDA-event ms (chip_smoke.py's ``cuda_ms``) and largest error against its
plain version, and each form's registers and spills (ptxas' where the
process built the library).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

TRAIT = "template <>\nconstexpr bool kInlineNet<CartpoleCost> = true;\n"
COSTS = {"pendulum": "PendulumCost", "acrobot": "AcrobotCost", "quadrotor2d": "Quadrotor2DCost",
         "quadrotor3d": "Quadrotor3DCost", "arm2": "Arm2Cost"}


def inlined_copy(root: Path, plant: str) -> Path:
    """The checkout's copy with kInlineNet true for ``plant``'s cost."""
    dst = root / "_checkout" / "inline_net"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns(
        "_checkout", "_build", "chiprun_out", ".git", "__pycache__"))
    core = dst / "control_toolkit_tpu_torch" / "csrc" / "neural_core.cuh"
    text = core.read_text()
    assert TRAIT in text, "kInlineNet's cartpole entry moved"
    core.write_text(text.replace(TRAIT, TRAIT + f"template <>\nconstexpr bool "
                                 f"kInlineNet<{COSTS[plant]}> = true;\n"))
    return dst


def one(root: Path, plant: str) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from control_toolkit_tpu_torch.ops import kernels
    from control_toolkit_tpu_torch.ops import neural_grad_cost_rollout as ng
    from control_toolkit_tpu_torch.ops import neural_rollout as nr
    from control_toolkit_tpu_torch.optimizers.kernel_families import neural

    kernels.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 92)
    S, U = kernels.PLANT_DIMS[plant]
    operands = {}
    for kind in ("mlp", "gru", "lstm"):
        ctrl = cs.net_controller(plant, kind, "mppi", cs.OPTIMIZER_CONFIG)
        model, pack = neural.net_model(ctrl.optimizer)
        lo, hi = ctrl.optimizer.action_low, ctrl.optimizer.action_high
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        params = ctrl._assemble_params()
        operands[kind] = (model, pack(params, mid + 0.1 * half), params["dyn"])
    s0 = cs.plant_states(plant, cs.K, gen)
    Q = torch.clamp(mid + half * (0.5 * torch.randn(cs.K, cs.H, U, generator=gen, device=dev)),
                    lo, hi)
    model, pvec, dyn = operands["mlp"]
    net = dyn["net"]
    forms = {
        "k11": (lambda: nr.neural_cost_rollout(model, s0, Q, pvec, net),
                lambda: (nr.neural_cost_rollout_plain(model, s0, Q, pvec, net),)),
        "k11_emit": (lambda: nr.neural_cost_rollout_emit(model, s0, Q, pvec, net),
                     lambda: nr.neural_cost_rollout_emit_plain(model, s0, Q, pvec, net)),
        "k8": (lambda: ng.neural_grad_cost_rollout(model, s0, Q, pvec, net),
               lambda: ng.neural_grad_cost_rollout_plain(model, s0, Q, pvec, net)),
    }
    for kind in ("gru", "lstm"):
        m, pv, d = operands[kind]
        forms[f"k13_{kind}"] = (
            lambda m=m, pv=pv, d=d: nr.recurrent_cost_rollout(m, s0, Q, pv, d["net"],
                                                              d["hidden"]),
            lambda m=m, pv=pv, d=d: (nr.recurrent_cost_rollout_plain(m, s0, Q, pv, d["net"],
                                                                     d["hidden"]),))
    cost = cs.COST_MANGLED[plant]
    entries = {"k11": ("neural_cost_rollout_kernel", cost),
               "k11_emit": ("neural_cost_rollout_emit_kernel", cost),
               "k13_gru": ("recurrent_cost_rollout_kernel", cost + r"(\w*E)?Li3EEEv"),
               "k13_lstm": ("recurrent_cost_rollout_kernel", cost + r"(\w*E)?Li4EEEv"),
               "k8": ("neural_grad_cost_rollout_kernel", cost)}
    built = bool(kernels.build.log)
    out = {"checkout": str(root), "library": kernels.library_path().name,
           "built_here_s": kernels.build.seconds if built else None}
    for name, (kernel, plain) in forms.items():
        got = kernel()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        out[name] = {"ms": cs.cuda_ms(kernel, 20),
                     "max_abs_err": max(float((g - r).abs().max()) for g, r in zip(got, ref)),
                     **(cs.ptxas_resources(*entries[name]) if built else {})}
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
    print("inline_net_times: " + json.dumps({"plant": plant, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
