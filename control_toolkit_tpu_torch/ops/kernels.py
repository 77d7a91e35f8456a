"""Build, load and describe the port's CUDA kernels (``csrc/``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and bound with ``ctypes``.  The build
runs at first use, goes to ``control_toolkit_tpu_torch/_build/`` (listed
in ``.gitignore``) and is keyed by a hash of the sources and flags; it
writes a temporary file and renames it into place, so an interrupted or
concurrent build never leaves a truncated library behind.  Nothing here
runs at import: the CPU tests import every module, and this machine may
have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("cost_rollout.cu", "mppi_cost.cu", "grad_cost_rollout.cu")
HEADERS = ("rollout_core.cuh", "plants.cuh")
# Per-source compile flags; the objects are then linked with -shared.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Device plants (csrc/plants.cuh): the id each C entry point dispatches on,
# and the packed-parameter order the plant reads — Optimizer._soa_bindings'
# order for its (dynamics, cost) pair.
PLANT_IDS = {"cartpole": 0}
PLANT_DIMS = {"cartpole": (4, 1)}  # (S, U)
PLANT_PARAM_KEYS = {
    "cartpole": (
        "d_L", "d_friction_cart", "d_friction_pole", "d_g", "d_m_cart",
        "d_m_pole", "d_u_max",
        "c_R", "c_cc_weight", "c_ccrc_weight", "c_dd_weight", "c_ekp_weight",
        "c_ep_weight",
        "a_target_position",
        "__u_prev_0",
    ),
}


@dataclass(frozen=True)
class RolloutModel:
    """What a rollout kernel integrates and scores, in both forms: the
    device plant's name for the CUDA kernel, and the component-form
    callables (over a dict of ``param_keys`` -> pvec entries) that the
    plain PyTorch versions run."""

    plant: str
    param_keys: Tuple[str, ...]
    derivs: Callable      # (xs, us, p) -> dxs
    stage: Callable       # (xs, us, prev_us, p) -> [K]; with ccrc and -MAX_COST
    terminal: Callable    # (xs, p) -> [K]
    integrator: str
    dt: float
    intermediate_steps: int
    max_cost: float

    def __post_init__(self):
        if self.plant not in PLANT_IDS:
            raise ValueError(f"no device plant {self.plant!r}; known: {sorted(PLANT_IDS)}")
        if self.param_keys != PLANT_PARAM_KEYS[self.plant]:
            raise ValueError(
                f"packed parameters {self.param_keys} do not match the "
                f"{self.plant!r} device plant's layout {PLANT_PARAM_KEYS[self.plant]}"
            )
        if self.integrator not in ("rk4", "euler"):
            raise ValueError(f"unknown integrator {self.integrator!r} (rk4 | euler)")

    def check_launch_shape(self, name: str, S: int, U: int, K: int, H: int,
                           N: int) -> None:
        """Raise unless the operands fit the device plant and are non-empty."""
        if (S, U) != PLANT_DIMS[self.plant] or N != len(self.param_keys) or K < 1 or H < 1:
            raise ValueError(
                f"{name}: S={S} U={U} N={N} K={K} H={H} do not fit the "
                f"{self.plant!r} plant (S, U) = {PLANT_DIMS[self.plant]}, "
                f"N = {len(self.param_keys)}"
            )

    def unpack(self, pvec: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: pvec[i] for i, k in enumerate(self.param_keys)}

    def step_args(self) -> tuple:
        """(rk4, substeps, sub_dt, half_dt, dt6) for the C entry points:
        float constants computed in double; ctypes rounds them to float."""
        sub_dt = self.dt / self.intermediate_steps
        return (
            int(self.integrator == "rk4"), int(self.intermediate_steps),
            sub_dt, 0.5 * sub_dt, sub_dt / 6.0,
        )


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libctt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` unless this source hash is built already; return
    the library's path.  Each source compiles in its own ``nvcc``, all
    started together, and the objects are linked into one library.
    ``build.count`` counts builds in this process, ``build.seconds`` and
    ``build.log`` (ptxas' register report) describe the last one."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    objs = [f"{tmp}.{Path(src).stem}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[1] for proc in procs]
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    os.replace(tmp, out)
    build.count += 1
    build.seconds = time.perf_counter() - t0
    build.log = "".join(logs)
    return out


build.count = 0
build.seconds = None
build.log = ""


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once."""
    if load.lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ctt_cost_rollout.argtypes = [
            i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_cost_rollout.restype = i32
        lib.ctt_mppi_cost.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            i32, i32, f32, f32, f32, f32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_mppi_cost.restype = i32
        lib.ctt_grad_cost_rollout.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, f32, f32, f32, f32, ptr,
        ]
        lib.ctt_grad_cost_rollout.restype = i32
        load.lib = lib
    return load.lib


load.lib = None


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_cuda_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """All operands float32, contiguous and on one CUDA device (which is
    returned); raises otherwise — a kernel never takes a mixed or CPU
    operand, and nothing falls back."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{name}: kernel operands must be CUDA tensors, got {device}")
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return device


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU: the only case in which a
    wrapper runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors)
