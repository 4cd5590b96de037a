"""Tracing / profiling hooks: the port of the JAX package's
`utils/profiling.py`.

  * `StageTimer` — accumulating per-stage wall-time stats for the serving
    edge's host-side stages (`/metrics` `stages`).
  * `device_time` — the minimum wall time of a call over a few trials,
    each fenced by a host readback of its result (a CUDA launch returns
    before the work is done; reading a value back waits for it).
  * `torch_trace` — a `torch.profiler` trace of a code region, written to
    a directory (the JAX package's `xla_trace`).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict

import numpy as np


class StageTimer:
    """Thread-safe accumulating timer: `with timer.stage("decode"): ...`."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._samples: Dict[str, collections.deque] = {}
        self._window = window

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._samples.setdefault(
                    name, collections.deque(maxlen=self._window)
                ).append(dt)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for name, q in self._samples.items():
                arr = np.asarray(q)
                out[name] = {
                    "count": int(arr.size),
                    "mean_ms": float(arr.mean() * 1e3),
                    "p50_ms": float(np.percentile(arr, 50) * 1e3),
                    "p95_ms": float(np.percentile(arr, 95) * 1e3),
                }
            return out


def device_time(fn, *args, readback=lambda out: out, trials: int = 3):
    """Time a device program honestly: (min wall seconds over `trials`,
    the last output), each trial fenced by reading the sum of
    `readback(out)` (a tensor or an array) back to the host."""
    import torch

    best = float("inf")
    out = None
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fn(*args)
        float(torch.as_tensor(readback(out)).sum())
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a `torch.profiler` trace of the region (host, and the
    GPU's kernels where CUDA is available) into `log_dir` as a Chrome /
    Perfetto trace file: the counterpart of the JAX package's
    `xla_trace` (`jax.profiler.start_trace`). Yields the profiler, whose
    `key_averages()` the caller may read."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
