"""K1, K2, K4 and K7, K11, K11's member-block form, K12, K13 (GRU and
LSTM) and K14 with the session-row forms of K11, K12 and K14, and the
gradient kernels K8, K8's member-block form, K9 and K10 with the
session-row forms of K1, K7, K8, K9 and K10, timed through their public
wrappers, and, where the checkout has them, their value forms (the
emit_terminal forms; the value_spec forms over chip_smoke.py's seeded V,
the gradient kernels' over the committed one), in the checkout given as
the argument:

    python probes/value_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels from its sources (so that ptxas reports each kernel's
registers), takes its chip_smoke.py's operands (K1, K2, K7 and the
learned kernels: the main path's, K=16384, H=50, over the committed nets,
the seeded residual, the well-conditioned GP and the GRU's and LSTM's
zero hidden; K4 and the session-row forms: the fleet's, B=32 and 128
sessions of K=512, H=35; the gradient kernels' session-row forms: phase
45's, 32 sessions of 512 rollouts, H=50) and prints one line,
``value_times: {...}``, of
CUDA-event milliseconds (chip_smoke.py's ``cuda_ms``), registers, the card
and the built library.
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
from control_toolkit_tpu_torch.models.networks import load_net  # noqa: E402
from control_toolkit_tpu_torch.ops import cost_rollout as k1  # noqa: E402
from control_toolkit_tpu_torch.ops import gp_grad_cost_rollout as k10  # noqa: E402
from control_toolkit_tpu_torch.ops import gp_rollout as k14  # noqa: E402
from control_toolkit_tpu_torch.ops import grad_cost_rollout as k7  # noqa: E402
from control_toolkit_tpu_torch.ops import kernels  # noqa: E402
from control_toolkit_tpu_torch.ops import mppi_cost as k2  # noqa: E402
from control_toolkit_tpu_torch.ops import mppi_cost_cols as k4  # noqa: E402
from control_toolkit_tpu_torch.ops import neural_grad_cost_rollout as k8  # noqa: E402
from control_toolkit_tpu_torch.ops import neural_rollout as k11  # noqa: E402
from control_toolkit_tpu_torch.ops import residual_grad_cost_rollout as k9  # noqa: E402
from control_toolkit_tpu_torch.ops import residual_rollout as k12  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import (  # noqa: E402
    ensemble, gp, neural, ode, residual,
)

REGISTERS = {"k1": ("cost_rollout_kernel", "Lb0E"), "k2": ("mppi_cost_kernel", ""),
             "k4": ("mppi_cost_cols_kernel", ""),
             "k7_forward": ("grad_cost_forward_kernel", "Lb0E"),
             "k7_adjoint": ("grad_cost_adjoint_kernel", "Lb0E"),
             "k1_emit": ("cost_rollout_emit_kernel", ""),
             "k2_emit": ("mppi_cost_emit_kernel", ""),
             "k4_emit": ("mppi_cost_cols_emit_kernel", ""),
             "k7_value_forward": ("grad_cost_forward_value_kernel", ""),
             "k7_value_adjoint": ("grad_cost_adjoint_value_kernel", ""),
             **{f"{label}{tail}": (f"{name}{tail}_kernel", instance)
                for label, (name, instance) in {
                    "k11": ("neural_cost_rollout", ""), "k11_ens": ("neural_cost_rollout_ens", ""),
                    "k12": ("residual_cost_rollout", ""),
                    "k13_gru": ("recurrent_cost_rollout", "Li3E"),
                    "k13_lstm": ("recurrent_cost_rollout", "Li4E"),
                    "k14": ("gp_cost_rollout", "Li4E")}.items()
                for tail in ("", "_emit")},
             **{f"{label}{tail}": (f"{name}{tail}_kernel", instance)
                for label, (name, instance) in {
                    "k8": ("neural_grad_cost_rollout", ""),
                    "k8_ens": ("neural_grad_cost_rollout_ens", ""),
                    "k9": ("residual_grad_cost_rollout", ""),
                    "k10": ("gp_grad_cost_rollout", "Li4E")}.items()
                for tail in ("", "_value")},
             "k7_value_rows_forward": ("grad_cost_forward_value_rows_kernel", ""),
             "k7_value_rows_adjoint": ("grad_cost_adjoint_value_rows_kernel", ""),
             "k1_emit_rows": ("cost_rollout_emit_rows_kernel", "")}


def grad_runs(dev, gen, s0, Qg) -> dict:
    """The gradient kernels K8, K8's member-block form, K9 and K10 and the
    session-row forms of K1, K7, K8, K9 and K10 and, where the checkout has
    them, their value forms over the committed V (K1's: its emit form),
    each a thunk over chip_smoke.py's operands."""
    runs = {}
    vnet = load_net(cs.VALUE_FILE, dev)[0]
    ops = [vnet[f"{c}{i}"].float().contiguous() for i in range(3) for c in "wb"]

    def add(label, module, name, args, value="_value"):
        runs[label] = lambda: getattr(module, name)(*args)
        if hasattr(module, f"{name}{value}"):
            extra = () if value == "_emit" else (ops,)
            runs[f"{label}{value}"] = lambda: getattr(module, f"{name}{value}")(*args, *extra)

    pvec_of = (lambda ctrl, pack:
               pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev)))
    mlp = cs.make_controller("cuda", "rpgd-tf", cs.RPGD_CONFIG, spec=cs.MLP_SPEC)
    model, pack = neural.net_model(mlp.optimizer)
    add("k8", k8, "neural_grad_cost_rollout",
        (model, s0, Qg, pvec_of(mlp, pack), mlp._assemble_params()["dyn"]["net"]))
    ens = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.ENS_SPEC)
    model, pack = ensemble.net_model(ens.optimizer)
    add("k8_ens", k8, "neural_grad_cost_rollout_ens",
        (model, s0, Qg, pvec_of(ens, pack), ens._assemble_params()["dyn"]["net"]))
    res = cs.residual_controller("rpgd-tf", cs.RES_RPGD_CONFIG)
    model, pack = residual.residual_model(res.optimizer)
    add("k9", k9, "residual_grad_cost_rollout",
        (model, s0, Qg, pvec_of(res, pack), res._assemble_params()["dyn"]["res"]))
    gpc = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.GP_SPEC)
    model, pack = gp.gp_model(gpc.optimizer)
    wops = k14.flatten_gp_weights(cs.well_conditioned_gp(gpc._assemble_params()["dyn"]["gp"]))
    add("k10", k10, "gp_grad_cost_rollout", (model, s0, Qg, pvec_of(gpc, pack), wops))
    cols = {"k1": (k1, "cost_rollout_cols", "_emit"),
            "k7": (k7, "grad_cost_rollout_cols", "_value"),
            "k8": (k8, "neural_grad_cost_rollout_cols", "_value"),
            "k9": (k9, "residual_grad_cost_rollout_cols", "_value"),
            "k10": (k10, "gp_grad_cost_rollout_cols", "_value")}
    for form, (module, name, value) in cols.items():
        fleet = cs.grad_fleet("cuda", cs.GRAD_COLS_FLEET[form], cs.FLEET_B)
        add(f"{form}_cols", module, name, cs.grad_cols_operands(form, fleet, 32, 512, gen), value)
    return runs


def learned_runs(dev, gen, s0, Q) -> dict:
    """The learned cost kernels and, where the checkout has them, their
    emit_terminal forms, each a thunk over chip_smoke.py's operands."""
    runs = {}

    def add(label, module, name, args):
        runs[label] = lambda: getattr(module, name)(*args)
        if hasattr(module, f"{name}_emit"):
            runs[f"{label}_emit"] = lambda: getattr(module, f"{name}_emit")(*args)

    pvec_of = (lambda ctrl, pack:
               pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev)))
    mlp = cs.make_controller("cuda", spec=cs.MLP_SPEC)
    model, pack = neural.net_model(mlp.optimizer)
    add("k11", k11, "neural_cost_rollout",
        (model, s0, Q, pvec_of(mlp, pack), mlp._assemble_params()["dyn"]["net"]))
    ens = cs.make_controller("cuda", "mppi", cs.RES_MPPI_CONFIG, spec=cs.ENS_SPEC)
    model, pack = ensemble.net_model(ens.optimizer)
    add("k11_ens", k11, "neural_cost_rollout_ens",
        (model, s0, Q, pvec_of(ens, pack), ens._assemble_params()["dyn"]["net"]))
    res = cs.residual_controller("rpgd-tf", cs.RES_RPGD_CONFIG)
    model, pack = residual.residual_model(res.optimizer)
    add("k12", k12, "residual_cost_rollout",
        (model, s0, Q, pvec_of(res, pack), res._assemble_params()["dyn"]["res"]))
    for label, spec in (("k13_gru", cs.GRU_SPEC), ("k13_lstm", cs.LSTM_SPEC)):
        rnn = cs.make_controller("cuda", spec=spec)
        model, pack = neural.net_model(rnn.optimizer)
        dyn = rnn._assemble_params()["dyn"]
        add(label, k11, "recurrent_cost_rollout",
            (model, s0, Q, pvec_of(rnn, pack), dyn["net"], dyn["hidden"]))
    gpc = cs.make_controller("cuda", "rpgd-tf", cs.RES_RPGD_CONFIG, spec=cs.GP_SPEC)
    model, pack = gp.gp_model(gpc.optimizer)
    ops = k14.flatten_gp_weights(cs.well_conditioned_gp(gpc._assemble_params()["dyn"]["gp"]))
    add("k14", k14, "gp_cost_rollout", (model, s0, Q, pvec_of(gpc, pack), ops))
    cols = {"mlp": (k11, "neural_cost_rollout_cols"),
            "residual": (k12, "residual_cost_rollout_cols"), "gp": (k14, "gp_cost_rollout_cols")}
    for kind, (module, name) in cols.items():
        args = cs.cols_operands(kind, cs.learned_fleet("cuda", kind, cs.FLEET_B), cs.FLEET_B_MAX,
                                gen)
        for b in (cs.FLEET_B, cs.FLEET_B_MAX):
            add(f"{kind}_cols_b{b}", module, name, cs.session_slice(args, b))
    return runs


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
    runs.update(learned_runs(dev, gen, s0, Q))
    runs.update(grad_runs(dev, gen, s0, Qg))
    out["ms"] = {name: cs.cuda_ms(fn, 50) for name, fn in runs.items()}
    print("value_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
