"""K7 (grad_cost_rollout) and K13 (recurrent_cost_rollout, the committed
GRU and a seeded LSTM of its widths) timed through their public wrappers
at K=2048, 8192 and 16384, H=50, in the checkout given as the argument:

    python probes/k7_k13_times.py <checkout root>

One process a checkout, so that two commits can be timed in one call on
one card, in turns (parent, change, change, parent).  It builds that
checkout's kernels, takes its chip_smoke.py's operands (the main path's
configuration, seed 0) and prints one line, ``k7_k13_times: {...}``, of
CUDA-event milliseconds (chip_smoke.py's ``cuda_ms``) and the card.
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
from control_toolkit_tpu_torch.ops.grad_cost_rollout import grad_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.ops.neural_rollout import recurrent_cost_rollout  # noqa: E402
from control_toolkit_tpu_torch.optimizers.kernel_families import neural, ode  # noqa: E402

SIZES = (2048, 8192, 16384)


def main() -> None:
    if Path(cs.__file__).resolve().parent != ROOT:
        raise SystemExit(f"chip_smoke.py came from {cs.__file__}, not {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    ctrl = cs.make_controller("cuda")
    model, pack = ode.rollout_model(ctrl.optimizer)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    pvec = pack(ctrl._assemble_params(), torch.tensor([0.1], device=dev))
    s0 = 0.05 * torch.randn(cs.K, 4, generator=gen, device=dev)
    Q = torch.clamp(0.3 * torch.randn(cs.K, cs.H, 1, generator=gen, device=dev), -1.0, 1.0)
    Qg = 2.0 * torch.rand(cs.K, cs.H, 1, generator=gen, device=dev) - 1.0
    out = {"root": str(ROOT), "card": card}
    for k in SIZES:
        s, q = s0[:k].contiguous(), Qg[:k].contiguous()
        out[f"k7_{k}"] = cs.cuda_ms(lambda: grad_cost_rollout(model, s, q, pvec), 50)
    for label, spec in (("gru", cs.GRU_SPEC), ("lstm", cs.LSTM_SPEC)):
        c = cs.make_controller("cuda", spec=spec)
        m, pk = neural.net_model(c.optimizer)
        params = c._assemble_params()
        pv = pk(params, torch.tensor([0.1], device=dev))
        net, hidden = params["dyn"]["net"], params["dyn"]["hidden"]
        for k in SIZES:
            s, q = s0[:k].contiguous(), Q[:k].contiguous()
            out[f"k13_{label}_{k}"] = cs.cuda_ms(
                lambda: recurrent_cost_rollout(m, s, q, pv, net, hidden), 50)
    print("k7_k13_times:", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
