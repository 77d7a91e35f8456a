"""chip_smoke.py's closed-loop evaluation phases (101-104) alone:

    python probes/eval_phases.py

Builds the kernels (one nvcc a source, as chip_smoke.py does), then runs
``ClosedLoop.run`` over the flagship and the GRU, ``run_batch``'s kernel
sweeps, the per-slot fleet step and the fleet checkpoints on the card as
chip_smoke.py does (same functions, same configurations) and prints their
lines, with the card's name and power limit first.  A quicker check of a
change to ``evaluation/``, ``utils/checkpoint.py`` or the batched
controller than the whole script.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    device = cs.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cs.kernels.load()
    print(f"build_seconds: {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    cs.eval_phases(torch.Generator(device=device).manual_seed(cs.SEED))
    print(f"eval_phases_seconds: {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
