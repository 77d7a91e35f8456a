"""Wall time of the kernel library's build in each checkout given, its
sources compiled as ``ops/kernels.py`` ``build()`` compiles them (one
``nvcc`` a source, all started together, then the link), with each
source's own time:

    python probes/build_times.py <checkout> [<checkout> ...]

A checkout may be named more than once (A B B A, to see the spread). Each
build starts from nothing: the checkout's library is removed first, and
the one built is left in its place (for ``probes/sass_same.py``).  One
process a build.  Prints one line, ``build_times: [...]``: for each build,
the checkout, the CPU count, the wall seconds of the compiles and of the
link, and each source's seconds from the common start.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path


def build(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from control_toolkit_tpu_torch.ops import kernels

    out = kernels.library_path()
    out.unlink(missing_ok=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    objs = [f"{out}.{Path(src).stem}.o" for src in kernels.SOURCES]
    nvcc = kernels._nvcc()
    t0 = time.perf_counter()
    procs = {src: subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", obj,
                                    str(kernels.CSRC_DIR / src)],
                                   stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(kernels.SOURCES, objs)}
    seconds = {}
    while len(seconds) < len(procs):
        for src, proc in procs.items():
            if src not in seconds and proc.poll() is not None:
                seconds[src] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr.read()}")
        time.sleep(0.02)
    compiled = time.perf_counter() - t0
    subprocess.run([nvcc, "-shared", "-o", str(out), *objs], check=True)
    total = time.perf_counter() - t0
    for obj in objs:
        Path(obj).unlink()
    return {"checkout": str(root), "cpus": os.cpu_count(), "compile_s": compiled,
            "total_s": total, "sources": len(seconds), "source_s": seconds}


def main() -> None:
    if sys.argv[1] == "--one":
        print(json.dumps(build(Path(sys.argv[2]).resolve())))
        return
    runs = []
    for root in sys.argv[1:]:
        done = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, check=True)
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    print("build_times: " + json.dumps(runs))


if __name__ == "__main__":
    main()
