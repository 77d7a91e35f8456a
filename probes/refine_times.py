"""Where mppi-optimize's host time goes, in the checkout given as the
argument:

    python probes/refine_times.py <checkout root>

At chip_smoke.py's two mppi-optimize configurations (MPPI_OPTIMIZE_CONFIG,
the port's defaults: K=400, H=35, 10 Adam steps; MPPI_OPTIMIZE_WIDE:
K=16384, H=50), built in one process and measured in turns (defaults,
wide, wide, defaults), each from CartpoleEnv(seed=0)'s start after
chip_smoke.py's PROFILE_WARMUP ticks.  Host milliseconds, each the median
of REPS calls that end in ``torch.cuda.synchronize()``:

- ``step``: one closed-loop ``ctrl.step`` (its own end is the control's
  copy to the host);
- ``update``: the MPPI update without the refinement (``optim_steps`` 0
  on the same state and draw);
- ``refine``: ``optimizer._make_refine()`` from the update's plan;
- ``k7_call``: one call of the refinement's gradient
  (``_make_nominal_grad``: K7's wrapper and the parameter packing);
- ``pack``: the packing alone (``ode.rollout_model``'s ``pack``);
- ``adam_clip``: one ``clip_by_norm``, ``adam_update`` and clamp on the
  plan;
- ``enqueue``: ``refine`` without the synchronize, the host's own time.

Prints one line, ``refine_times: {...}``, with the card's name.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from control_toolkit_tpu_torch.environments.cartpole import CartpoleEnv  # noqa: E402
from control_toolkit_tpu_torch.ops.common import (  # noqa: E402
    adam_init, adam_update, clip_by_norm,
)
from control_toolkit_tpu_torch.optimizers.kernel_families import ode  # noqa: E402

REPS = 30


def host_ms(fn, sync: bool = True) -> float:
    """Median host milliseconds of REPS calls of ``fn``, each synchronized
    before it starts and (``sync``) before it is read."""
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def measure(ctrl) -> dict:
    opt = ctrl.optimizer
    env = CartpoleEnv(batch_size=1, dt=cs.DT, seed=cs.SEED)
    s = env.reset()[0]
    for _ in range(cs.PROFILE_WARMUP):
        s, *_ = env.step(ctrl.step(s[0]))
    s_dev = torch.tensor(s[:1], device=opt.device)
    params = ctrl._assemble_params()
    state, noise = opt.opt_state, opt.sample_noise(opt.opt_state)
    refine, grad = opt._make_refine(), opt._make_nominal_grad()
    steps = opt.optim_steps
    opt.optim_steps = 0
    plain_update = opt._make_semi_fused_update()
    opt.optim_steps = steps
    _, _, diag = plain_update(state, s_dev, params, noise)
    u_nom, up = diag["u_nom"], state.u_prev
    _, pack = ode.rollout_model(opt)
    lo, hi = opt.action_low, opt.action_high

    def adam_clip():
        g = clip_by_norm(u_nom, opt.gradmax_clip, axes=(-2, -1))
        _, delta = adam_update(adam_init(u_nom.shape, u_nom.device), g, opt.mppi_LR,
                               opt.adam_beta_1, opt.adam_beta_2, opt.adam_epsilon)
        torch.clamp(u_nom - delta, lo, hi)

    return {
        "step": host_ms(lambda: ctrl.step(s[0])),
        "update": host_ms(lambda: plain_update(state, s_dev, params, noise)),
        "refine": host_ms(lambda: refine(u_nom, s_dev, up, params)),
        "enqueue": host_ms(lambda: refine(u_nom, s_dev, up, params), sync=False),
        "k7_call": host_ms(lambda: grad(u_nom, s_dev, up, params)),
        "pack": host_ms(lambda: pack(params, up)),
        "adam_clip": host_ms(adam_clip),
        "optim_steps": steps,
    }


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    ctrls = {"defaults": cs.make_controller("cuda", "mppi-optimize-tf", cs.MPPI_OPTIMIZE_CONFIG),
             "wide": cs.make_controller("cuda", "mppi-optimize-tf", cs.MPPI_OPTIMIZE_WIDE)}
    runs = {k: [] for k in ctrls}
    for label in ("defaults", "wide", "wide", "defaults"):
        runs[label].append(measure(ctrls[label]))
    print("refine_times: " + json.dumps({"card": torch.cuda.get_device_name(0), **runs}),
          flush=True)


if __name__ == "__main__":
    main()
