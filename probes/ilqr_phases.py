"""chip_smoke.py's iLQR phases (98-100) alone, without the kernels' build:

    python probes/ilqr_phases.py [--full]

The iLQR family launches no kernel of the port's, so its phases need no
library; this runs them on the card as chip_smoke.py does (same
functions, same configurations) and prints their lines, with the card's
name and power limit first.  A quicker check of a change to
``optimizers/ilqr.py`` than the whole script.  ``--full`` first profiles
a whole tick (after a warm-up tick) of each of phase 98's three solves at
the defaults, the reads that ``ilqr_tick_profile`` draws its line through
(~30 s a tick: ~5e5 device operations to record and read).
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
    if "--full" in sys.argv[1:]:
        for label, extra in cs.ILQR_PATHS.items():
            tick = cs.env_tick(cs.make_controller("cuda", "ilqr", {**cs.ILQR_CONFIG, **extra}))
            tick()
            cs.emit(f"profile_full_ilqr_{label}", cs.ilqr_profile(label, tick))
    t0 = time.perf_counter()
    cs.ilqr_phases(torch.Generator(device=device).manual_seed(cs.SEED))
    print(f"ilqr_phases_seconds: {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
