"""The ODE kernels over the exact cartpole plant and, where the checkout
has it, over the fast (polynomial-trig, ":fast") plant, timed through
their public wrappers in the checkout given as the argument:

    python probes/fast_times.py <checkout root>

K1, K2, K3's two passes, K5 and K7 (its forward and adjoint together) at
chip_smoke.py's main path (K=16384, H=50), K4 and K6 at its fleet's
(128 sessions of K=512, H=35), K12 and K9 over its seeded residual; each
fast form also against its plain version on the same card tensors
(``fast_max_abs_err``).  One process a checkout, so that two commits can
be timed in one call on one card, in turns (parent, change, change,
parent).  It builds that checkout's kernels from its sources and prints
one line, ``fast_times: {...}``, of CUDA-event milliseconds
(chip_smoke.py's ``cuda_ms``), the card, the built library and, from
ptxas' report of the build, the registers and spill bytes of each listed
kernel's single-session instance (``registers``) and of every fast entry
beside its exact counterpart (``fast_entries``).
"""
from __future__ import annotations

import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from control_toolkit_tpu_torch.ops import cost_rollout as k1  # noqa: E402
from control_toolkit_tpu_torch.ops import fused_cem as k5  # noqa: E402
from control_toolkit_tpu_torch.ops import fused_cem_cols as k6  # noqa: E402
from control_toolkit_tpu_torch.ops import fused_mppi as k3  # noqa: E402
from control_toolkit_tpu_torch.ops import grad_cost_rollout as k7  # noqa: E402
from control_toolkit_tpu_torch.ops import kernels  # noqa: E402
from control_toolkit_tpu_torch.ops import mppi_cost as k2  # noqa: E402
from control_toolkit_tpu_torch.ops import mppi_cost_cols as k4  # noqa: E402
from control_toolkit_tpu_torch.ops import residual_grad_cost_rollout as k9  # noqa: E402
from control_toolkit_tpu_torch.ops import residual_rollout as k12  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import ode, residual  # noqa: E402

ENTRIES = {"k1": "cost_rollout_kernel", "k2": "mppi_cost_kernel",
           "k3_pass1": "fused_mppi_cost_kernel", "k4": "mppi_cost_cols_kernel",
           "k5": "fused_cem_kernel", "k6": "fused_cem_cols_kernel",
           "k7_forward": "grad_cost_forward_kernel", "k7_adjoint": "grad_cost_adjoint_kernel",
           "k12": "residual_cost_rollout_kernel", "k9": "residual_grad_cost_rollout_kernel"}


FAST_PLANT, EXACT_PLANT = "17CartpoleFastPlantE", "13CartpolePlantE"


def resources() -> dict:
    """Each entry function of ptxas' report of the build (mangled name) ->
    its registers and spill bytes, the first report of a name."""
    out, entries, name = {}, set(), None
    for line in kernels.build.log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entries.add(m.group(1))
        elif m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1) if m.group(1) not in out else None
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
        elif name in out and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
            name = None
    return {fn: r for fn, r in out.items() if fn in entries and "registers" in r}


def single_session(res: dict, kernel: str, fast: bool):
    """The resources of ``kernel``'s single-session instance over the exact
    or fast cartpole plant: the entry named ``_ZN3ctt<n><kernel>INS_<plant>``
    and then ``E`` (one template argument) or ``Lb0EE`` (``Rows = false``)."""
    head = f"_ZN3ctt{len(kernel)}{kernel}INS_{FAST_PLANT if fast else EXACT_PLANT}"
    return next((r for fn, r in res.items()
                 if fn.startswith(head + "E") or fn.startswith(head + "Lb0EE")), None)


def fast_entries(res: dict) -> dict:
    """Every fast entry (over the fast plant, or K3's fast pass 2) -> its
    resources and its exact counterpart's."""
    out = {}
    for fn, r in res.items():
        if FAST_PLANT in fn:
            exact = fn.replace(FAST_PLANT, EXACT_PLANT)
        elif "30fused_mppi_weights_fast_kernel" in fn:
            exact = fn.replace("30fused_mppi_weights_fast_kernel", "25fused_mppi_weights_kernel")
        else:
            continue
        out[fn] = {"fast": r, "exact": res.get(exact)}
    return out


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library_path().unlink(missing_ok=True)
    kernels.load()
    dev = torch.device("cuda")
    has_fast = "cartpole_fast" in kernels.PLANT_IDS
    res = resources()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": str(ROOT), "card": card, "library": kernels.library_path().name,
           "build_seconds": kernels.build.seconds,
           "registers": {name: {"exact": single_session(res, entry, False),
                                **({"fast": single_session(res, entry, True)} if has_fast
                                   else {})}
                         for name, entry in ENTRIES.items()},
           "fast_entries": fast_entries(res)}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ctrl = cs.make_controller("cuda")
    opt = ctrl.optimizer
    model, pack = ode.rollout_model(opt)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev))
    K, H = cs.K, cs.H
    s0 = 0.05 * torch.randn(K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(K, H, 1, generator=gen, device=dev), -1.0, 1.0)
    Qg = 2.0 * torch.rand(K, H, 1, generator=gen, device=dev) - 1.0
    W, low, high = opt.interp.matrix, opt.action_low, opt.action_high
    P, stdev = W.shape[0], opt.SQRTRHODTINV
    eps = stdev * torch.randn(P, 1, K, generator=gen, device=dev)
    u_nom = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=dev), -1.0, 1.0)
    x0 = torch.tensor([0.02, -0.1, 0.05, 0.1], device=dev)
    seed2 = torch.tensor([7654321, 0], dtype=torch.int32, device=dev)
    mue = torch.clamp(0.2 * torch.randn(H, 1, generator=gen, device=dev), -1.0, 1.0)
    std = torch.full((H, 1), 0.5, device=dev)
    fleet = cs.fleet_controller("cuda", "mppi", cs.FLEET_MPPI_CONFIG, cs.FLEET_B)
    fopt = fleet.optimizer
    B, Kf, Hf = cs.FLEET_B_MAX, fopt.num_rollouts, fopt.mpc_horizon
    fmodel, pvec_b, sb = cs.fleet_operands(fopt, B, gen)
    u_nom_b = torch.clamp(0.2 * torch.randn(B, Hf, 1, generator=gen, device=dev), -1.0, 1.0)
    eps_b = fopt.SQRTRHODTINV * torch.randn(B, fopt.interp.matrix.shape[0], 1, Kf,
                                            generator=gen, device=dev)
    mue_b = torch.clamp(0.2 * torch.randn(B, Hf, 1, generator=gen, device=dev), -1.0, 1.0)
    std_b = torch.full((B, Hf, 1), 0.5, device=dev)
    seed_b = torch.randint(0, 2**31 - 1, (B,), generator=gen, dtype=torch.int32, device=dev)
    res = cs.residual_controller("rpgd-tf", cs.RES_RPGD_CONFIG)
    rmodel, rpack = residual.residual_model(res.optimizer)
    rparams = res._assemble_params()
    rpvec, rnet = rpack(rparams, torch.tensor([0.1], device=dev)), rparams["dyn"]["res"]
    weights_fast = "fast" in inspect.signature(k3.fused_mppi_weights).parameters

    def runs(m, fm, rm):
        """(kernel thunk, plain thunk) of each kernel over the models m (the
        main path's), fm (the fleet's) and rm (the residual's)."""
        fast = m.plant != "cartpole"
        a3 = (m, x0, u_nom, pvec, seed2, W, low, high, opt.cc_weight, opt.R, opt.NU, stdev, K,
              cs.DEFAULT_TILE_K)
        cost = k3.fused_mppi_costs(*a3)
        rho = torch.amin(cost)
        red = torch.stack([rho, torch.sum(torch.exp(-(cost - rho) / opt.LBD))])
        a3b = (seed2, cost, red, P, 1, opt.LBD, K, cs.DEFAULT_TILE_K)
        kw3b = {"fast": fast} if weights_fast else {}
        a2 = (m, s0[0].contiguous(), u_nom, pvec, eps, W, low, high, opt.cc_weight, opt.R, opt.NU)
        a4 = (fm, sb, u_nom_b, pvec_b, eps_b, fopt.interp.matrix, fopt.action_low,
              fopt.action_high, fopt.cc_weight, fopt.R, fopt.NU)
        a5 = (m, x0, mue, std, pvec, seed2, low, high, K, cs.DEFAULT_TILE_K)
        a6 = (fm, sb, mue_b, std_b, pvec_b, seed_b, low, high, Kf)
        return {
            "k1": (lambda: k1.cost_rollout(m, s0, Q, pvec),
                   lambda: k1.cost_rollout_plain(m, s0, Q, pvec)),
            "k2": (lambda: k2.mppi_cost(*a2), lambda: k2.mppi_cost_plain(*a2)),
            "k3_pass1": (lambda: k3.fused_mppi_costs(*a3), lambda: k3.fused_mppi_costs_plain(*a3)),
            "k3_pass2": (lambda: k3.fused_mppi_weights(*a3b, **kw3b).sum(0),
                         lambda: k3.fused_mppi_weights_plain(*a3b, **kw3b).sum(0)),
            "k4": (lambda: k4.mppi_cost_cols(*a4), lambda: k4.mppi_cost_cols_plain(*a4)),
            "k5": (lambda: k5.fused_cem_costs(*a5), lambda: k5.fused_cem_costs_plain(*a5)),
            "k6": (lambda: k6.fused_cem_cols(*a6), lambda: k6.fused_cem_cols_plain(*a6)),
            "k7": (lambda: k7.grad_cost_rollout(m, s0, Qg, pvec)[1],
                   lambda: k7.grad_cost_rollout_plain(m, s0, Qg, pvec)[1]),
            "k12": (lambda: k12.residual_cost_rollout(rm, s0, Q, rpvec, rnet),
                    lambda: k12.residual_cost_rollout_plain(rm, s0, Q, rpvec, rnet)),
            "k9": (lambda: k9.residual_grad_cost_rollout(rm, s0, Qg, rpvec, rnet)[1],
                   lambda: k9.residual_grad_cost_rollout_plain(rm, s0, Qg, rpvec, rnet)[1]),
        }

    exact = runs(model, fmodel, rmodel)
    out["ms"] = {name: cs.cuda_ms(fn, 50) for name, (fn, _) in exact.items()}
    if has_fast:
        # The fast models from ":fast" controllers: the fast plant's id for
        # the kernels, its derivs for the plain versions.
        fast = runs(ode.rollout_model(cs.make_controller("cuda", spec=cs.FAST_SPEC).optimizer)[0],
                    ode.rollout_model(cs.fleet_controller(
                        "cuda", "mppi", cs.FLEET_MPPI_CONFIG, cs.FLEET_B,
                        cs.FAST_SPEC).optimizer)[0],
                    residual.residual_model(cs.residual_controller(
                        "rpgd-tf", cs.RES_RPGD_CONFIG, cs.RES_FAST_SPEC).optimizer)[0])
        out["fast_ms"] = {name: cs.cuda_ms(fn, 50) for name, (fn, _) in fast.items()}
        out["fast_max_abs_err"], out["fast_vs_exact_max_abs"] = {}, {}
        for name, (fn, plain) in fast.items():
            got, ref = fn(), plain()
            out["fast_max_abs_err"][name] = float((got - ref).abs().max())
            out["fast_vs_exact_max_abs"][name] = float((got - exact[name][0]()).abs().max())
        out["ms_again"] = {name: cs.cuda_ms(fn, 50) for name, (fn, _) in exact.items()}
    print("fast_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
