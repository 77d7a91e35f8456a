"""Whether two checkouts' kernel libraries hold the same machine code for
the entry functions whose mangled names match the given patterns:

    python probes/sass_same.py <checkout A> <checkout B> [pattern ...]
    python probes/sass_same.py --digests <checkout>

Each checkout's library is the one its kernels last built
(``control_toolkit_tpu_torch/_build/*.so``, e.g. by
``probes/value_times.py``); run it where ``cuobjdump`` is (the CUDA
toolkit).  An entry's SASS is compared instruction by instruction, the
addresses and encodings left out.  Without patterns every entry of
checkout A's library is compared (an entry that a change recompiled,
its body unchanged, must keep its code).  Prints one line, ``sass_same:
{...}``: for each matching entry, whether both libraries hold it, whether
its instructions are the same, and their count in each; then one line,
``sass_differ: [...]``, the entries both hold whose code differs.

``--digests`` prints, as one JSON object, the compiler's release line
(``toolchain``) and each entry of the checkout's library with its
instruction count and the sha256 of its instructions (``digests``), to
keep beside a run or compare with another build by the same compiler.

A change that touches a body the exact entries share with other forms
runs ``python probes/sass_same.py <parent checkout> .`` on the card, both
libraries built in the same call: the exact entries it did not mean to
change must keep their code.
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def library(root: Path) -> Path:
    libs = sorted((root / "control_toolkit_tpu_torch" / "_build").glob("*.so"),
                  key=lambda p: p.stat().st_mtime)
    if not libs:
        raise SystemExit(f"no built kernel library under {root}")
    return libs[-1]


def functions(lib: Path) -> dict:
    """Entry name -> its SASS instructions (text only)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and op:
            out[name].append(op.group(1))
    return out


def toolchain(tool: str | None = None) -> str:
    """The ``release`` line of ``nvcc --version`` (``tool``: that nvcc)."""
    tool = tool or shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    text = subprocess.run([tool, "--version"], capture_output=True, text=True,
                          check=True).stdout
    return next(line.strip() for line in text.splitlines() if "release" in line)


def digests(lib: Path) -> dict:
    """Entry name -> [its instruction count, the sha256 of its instructions
    joined by newlines]."""
    return {name: [len(ins), hashlib.sha256("\n".join(ins).encode()).hexdigest()]
            for name, ins in functions(lib).items()}


def main() -> None:
    if sys.argv[1] == "--digests":
        print(json.dumps({"nvcc": toolchain(),
                          "entries": digests(library(Path(sys.argv[2]).resolve()))},
                         indent=0, sort_keys=True))
        return
    a, b = (functions(library(Path(p).resolve())) for p in sys.argv[1:3])
    patterns = sys.argv[3:]
    found = {}
    for name in sorted(set(a) | set(b)):
        if any(re.search(p, name) for p in patterns) if patterns else name in a:
            found[name] = {"in_both": name in a and name in b,
                           "same": a.get(name) == b.get(name),
                           "instructions": [len(a.get(name, [])), len(b.get(name, []))]}
    print("sass_same:", json.dumps(found), flush=True)
    print("sass_differ:", json.dumps([name for name, f in found.items()
                                      if f["in_both"] and not f["same"]]), flush=True)


if __name__ == "__main__":
    main()
