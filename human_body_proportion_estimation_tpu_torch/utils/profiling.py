"""Per-stage wall-time statistics for the serving edge (`/metrics`
`stages`): the `StageTimer` of the JAX package's `utils/profiling.py`.

The JAX module's `device_time` and `xla_trace` are not ported yet; their
port is CUDA-event timing and the torch profiler (ROADMAP.md item 16).
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
