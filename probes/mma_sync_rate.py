"""The card's rate and latency for the port's tensor-core instruction,
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` (csrc/mlp_mma.cuh,
csrc/rnn_mma.cuh), measured on the card that runs it.

    python probes/mma_sync_rate.py

builds a small CUDA kernel with nvcc (sm_90a) into
control_toolkit_tpu_torch/_build/ and times, with CUDA events:
- ``rate``: every warp issues 8 independent accumulator chains, two
  blocks of 512 threads (32 warps) on every SM, and one block (16 warps):
  the instruction's throughput in TFLOP/s (2 * 16 * 8 * 8 operations
  each);
- ``latency``: one warp on one SM issues one dependent chain: cycles a
  mma from issue to the next mma's operand (at the SM clock nvidia-smi
  reads).
It prints one JSON line with the card's name and power limit.  Needs a
card and nvcc; the port's kernels need not be built.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from control_toolkit_tpu_torch.ops import kernels  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CHAINS>
__global__ void chains(float* out, int iters) {
  const uint32_t x = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const uint32_t a[4] = {x, x ^ 0x2000u, x, x};
  float d[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma(d[c], a, x, x);
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int chains_, int blocks, int threads, int iters, float* out) {
  if (chains_ == 8) chains<8><<<blocks, threads>>>(out, iters);
  else chains<1><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    out = kernels.BUILD_DIR / "mma_sync_rate.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "mma_sync_rate.cu"
    src.write_text(SOURCE)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    return lib


def timed_ms(lib, chains: int, blocks: int, threads: int, iters: int) -> float:
    out = torch.empty(blocks * threads, device="cuda")
    for _ in range(2):
        assert lib.run(chains, blocks, threads, iters, out.data_ptr()) == 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    assert lib.run(chains, blocks, threads, iters, out.data_ptr()) == 0
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 512, 4096
    rate = {}
    for per_sm in (2, 1):
        ms = timed_ms(lib, 8, per_sm * sms, threads, iters)
        flop = per_sm * sms * threads / 32 * iters * 8 * 2 * 16 * 8 * 8
        rate[f"{per_sm * threads // 32}_warps_per_sm_tflops"] = flop / ms / 1e9
    lat_iters = 1 << 16
    lat_ms = timed_ms(lib, 1, 1, 32, lat_iters)
    clock_mhz = float(smi.split(",")[2].split()[0])
    print(json.dumps({"card": smi, **rate,
                      "latency_cycles_at_max_clock": lat_ms * 1e-3 / lat_iters * clock_mhz * 1e6,
                      "latency_ns": lat_ms * 1e6 / lat_iters}), flush=True)


if __name__ == "__main__":
    main()
