"""Wall time of the kernel library's build in each checkout given, its
sources compiled as that checkout's ``ops/kernels.py`` ``build()``
compiles them (one ``nvcc`` a source: one a CPU at a time, the heaviest
first, where the checkout has ``compile_sources``; else all started
together), then the link, with each source's own time:

    python probes/build_times.py <checkout> [<checkout> ...]

A checkout may be named more than once (A B B A, to see the spread). Each
build starts from nothing: the checkout's library is removed first, and
the one built is left in its place (for ``probes/sass_same.py``).  One
process a build.  Prints one line, ``build_times: [...]``: for each build,
the checkout, the CPU count, the wall seconds of the compiles and of the
link, each source's seconds from the common start, and the CPU seconds
each source's nvcc and the compilers it ran took (their sum over the CPU
count bounds the compiles' wall time from below).
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
    if hasattr(kernels, "compile_sources"):
        b = kernels.build
        b()
        return {"checkout": str(root), "cpus": os.cpu_count(), "compile_s": b.compile_seconds,
                "total_s": b.seconds, "sources": len(b.source_seconds),
                "source_s": b.source_seconds, "cpu_s": b.cpu_seconds,
                "cpu_total_s": sum(b.cpu_seconds.values())}
    objs = [f"{out}.{Path(src).stem}.o" for src in kernels.SOURCES]
    nvcc = kernels._nvcc()
    logs = {src: open(f"{obj}.log", "w+") for src, obj in zip(kernels.SOURCES, objs)}
    t0 = time.perf_counter()
    started = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", obj,
                                 str(kernels.CSRC_DIR / src)],
                                stdout=subprocess.DEVNULL, stderr=logs[src])
               for src, obj in zip(kernels.SOURCES, objs)]
    procs = {proc.pid: src for proc, src in zip(started, kernels.SOURCES)}
    seconds, cpu = {}, {}
    while len(seconds) < len(procs):
        # wait4: each nvcc's exit and the CPU seconds of it and the
        # compilers it ran (cudafe++, cicc, ptxas, the host compiler).
        pid, status, usage = os.wait4(-1, 0)
        if pid not in procs:
            continue
        src = procs[pid]
        seconds[src] = time.perf_counter() - t0
        cpu[src] = usage.ru_utime + usage.ru_stime
        if os.waitstatus_to_exitcode(status) != 0:
            logs[src].seek(0)
            raise SystemExit(f"nvcc failed on {src}:\n{logs[src].read()}")
    compiled = time.perf_counter() - t0
    subprocess.run([nvcc, "-shared", "-o", str(out), *objs], check=True)
    total = time.perf_counter() - t0
    for obj in objs:
        Path(obj).unlink()
        Path(f"{obj}.log").unlink()
    return {"checkout": str(root), "cpus": os.cpu_count(), "compile_s": compiled,
            "total_s": total, "sources": len(seconds), "source_s": seconds,
            "cpu_s": cpu, "cpu_total_s": sum(cpu.values())}


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
