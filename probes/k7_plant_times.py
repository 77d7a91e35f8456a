"""K7 over the quadrotor, car and arm plants, its forward and adjoint
launches timed apart, in the checkout given as the argument:

    python probes/k7_plant_times.py <checkout root> [plant ...]

At chip_smoke.py's main path (K=16384, H=50) over each plant (default: the
ten of chip_smoke.py REST_CASES), with the operands chip_smoke.py's
phase 77 draws; each result also held against its plain version
(``dQ_max_abs_err``, ``dQ_max_abs``).  One process a checkout, so that two
designs of the adjoint can be timed in one call on one card, in turns.  It
builds that checkout's kernels unless their library is built already, and
prints one line,
``k7_plant_times: {...}``: CUDA-event milliseconds (chip_smoke.py's
``cuda_ms``) of the forward, of the adjoint over the forward's states and
of the two together, and the adjoint's blocks per SM and, where this
process built the library, ptxas' registers and spill bytes
(chip_smoke.py ``plant_resources``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from control_toolkit_tpu_torch.ops import grad_cost_rollout as k7  # noqa: E402
from control_toolkit_tpu_torch.ops import kernels  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import ode  # noqa: E402


def main() -> None:
    plants = sys.argv[2:] or list(cs.REST_CASES)
    lib = kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"card": torch.cuda.get_device_name(0), "library": kernels.library_path().name}
    for plant in plants:
        ctrl = cs.plant_controller(plant, "rpgd-tf", cs.RPGD_CONFIG)
        model, pack = ode.rollout_model(ctrl.optimizer)
        S, U = kernels.PLANT_DIMS[plant]
        pvec = pack(ctrl._assemble_params(), torch.full((U,), 0.1, device="cuda"))
        s0 = cs.plant_states(plant, cs.K, gen)
        lo, hi = ctrl.optimizer.action_low, ctrl.optimizer.action_high
        Q = lo + (hi - lo) * torch.rand(cs.K, cs.H, U, generator=gen, device="cuda")
        H, Kk = cs.H, cs.K
        cost = torch.empty(Kk, device="cuda")
        xhist = torch.empty(H + 1, S, Kk, device="cuda")
        dQ = torch.empty_like(Q)
        pid, step = kernels.PLANT_IDS[plant], model.step_args()
        stream = torch.cuda.current_stream().cuda_stream
        ct = 1.0 / (H + 1)

        def forward():
            kernels.check_launch(lib.ctt_grad_cost_forward(
                pid, s0.data_ptr(), Q.data_ptr(), pvec.data_ptr(), cost.data_ptr(),
                xhist.data_ptr(), Kk, Kk, H, *step, model.max_cost, stream), "forward")

        def adjoint():
            kernels.check_launch(lib.ctt_grad_cost_adjoint(
                pid, Q.data_ptr(), pvec.data_ptr(), xhist.data_ptr(), None, dQ.data_ptr(), Kk,
                Kk, H, *step, ct, stream), "adjoint")

        forward()
        adjoint()
        _, ref = k7.grad_cost_rollout_plain(model, s0, Q, pvec)
        out[plant] = {
            "forward_ms": cs.cuda_ms(forward, 20), "adjoint_ms": cs.cuda_ms(adjoint, 20),
            "k7_ms": cs.cuda_ms(lambda: k7.grad_cost_rollout(model, s0, Q, pvec), 20),
            "dQ_max_abs_err": float((dQ - ref).abs().max()), "dQ_max_abs": float(ref.abs().max()),
            "adjoint": cs.plant_resources(plant)["k7_adjoint"],
        }
    print(f"k7_plant_times: {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
