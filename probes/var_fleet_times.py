"""The mppi-var fleet's tick beside the MPPI fleet's, host time in turns:

    python probes/var_fleet_times.py

From the repository's root, on the card.  Builds an MPPI fleet
(chip_smoke.py's FLEET_MPPI_CONFIG) and an mppi-var fleet
(FLEET_VAR_CONFIG) at B=32 and 128 sessions of K=512, H=35, and times
``step_batch`` with every slot active, ROUNDS rounds of TICKS ticks in
turns (MPPI, mppi-var, mppi-var, MPPI): host p50 of each round.  Then one
tick of each under ``torch.profiler`` with the CPU activity only: the host
operators that took the most self time, their counts, and the number of
operators in all.  Prints one line, ``var_fleet_times: {...}``, with the
card and its power limit.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from control_toolkit_tpu_torch.ops import kernels

ROUNDS, TICKS, WARMUP = 4, 50, 5


def host_p50(ctrl, s, mask) -> float:
    times = []
    for _ in range(TICKS):
        t0 = time.perf_counter()
        ctrl.step_batch(s, mask)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50))


def host_ops(ctrl, s, mask) -> dict:
    """One tick's host operators (torch.profiler, CPU activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctrl.step_batch(s, mask)
    events = prof.key_averages()
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:10]
    return {"operators": int(sum(e.count for e in events)),
            "top_self_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top]}


def main() -> None:
    kernels.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card}
    gen = torch.Generator().manual_seed(0)
    for B in (cs.FLEET_B, cs.FLEET_B_MAX):
        fleets = {"mppi": cs.fleet_controller("cuda", "mppi", cs.FLEET_MPPI_CONFIG, B),
                  "mppi_var": cs.fleet_controller("cuda", "mppi-var-tf", cs.FLEET_VAR_CONFIG, B)}
        s = (0.05 * torch.randn(B, 4, generator=gen)).numpy()
        mask = np.ones(B, bool)
        for c in fleets.values():
            for _ in range(WARMUP):
                c.step_batch(s, mask)
        rounds = {k: [] for k in fleets}
        for _ in range(ROUNDS // 2):
            for k in ("mppi", "mppi_var", "mppi_var", "mppi"):
                rounds[k].append(host_p50(fleets[k], s, mask))
        out[f"b{B}"] = {"host_p50_ms_rounds": rounds,
                        **{f"{k}_host_ops": host_ops(c, s, mask) for k, c in fleets.items()}}
    print(f"var_fleet_times: {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
