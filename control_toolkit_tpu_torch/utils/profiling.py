"""Latency instrumentation (counterpart of
control_toolkit_tpu/utils/profiling.py).

``LatencyTracker`` keeps a rolling window of per-step wall times and
reports their percentiles (the controller step's p50/p99);
``torch_trace(log_dir)`` records a ``torch.profiler`` trace of its block,
CPU and (on the card) CUDA activity, and exports it as a Chrome trace
(``<log_dir>/trace.json``, viewable in Perfetto).
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Dict

import numpy as np
import torch


class LatencyTracker:
    """Rolling per-step latency statistics."""

    def __init__(self, capacity: int = 10000):
        self.capacity = int(capacity)
        # deque(maxlen): O(1) eviction inside the path being measured.
        self._samples = deque(maxlen=self.capacity)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self._samples.append(seconds)

    def __len__(self) -> int:
        return len(self._samples)

    def percentiles(self) -> Dict[str, float]:
        if not self._samples:
            return {}
        ms = np.asarray(self._samples) * 1e3
        return {
            "count": float(len(ms)),
            "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(np.max(ms)),
            "mean_ms": float(np.mean(ms)),
        }

    def report(self) -> str:
        p = self.percentiles()
        if not p:
            return "no latency samples recorded"
        return (
            f"controller.step latency over {int(p['count'])} steps: "
            f"p50={p['p50_ms']:.3f}ms p90={p['p90_ms']:.3f}ms "
            f"p99={p['p99_ms']:.3f}ms max={p['max_ms']:.3f}ms"
        )

    def reset(self) -> None:
        self._samples.clear()


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write ``<log_dir>/trace.json``
    as a Chrome trace.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))
