"""Triton trace-extension analog (GET/POST /v2/trace/setting).

Triton ships a trace extension: the server samples every
``trace_rate``-th inference request and appends per-request timestamp
records to ``trace_file``; ``tritonclient`` exposes it as
get_trace_settings / update_trace_settings. The reference deploys stock
Triton (README.md:41-55), so this surface exists on its server even
though its drivers never toggle it. Here the same settings document
controls sampling of requests flowing through the dynamic batcher (the
domain image path) and the named-model registry (tensor-level
ModelInfer), writing one JSON record per traced request with measured
wall-clock nanosecond timestamps.

Wire form matches Triton's: the settings document is string-valued
(``{"trace_level": ["TIMESTAMPS"], "trace_rate": "1000", ...}``), POST
accepts ints or numeric strings, unknown fields or bad values are the
extension's 400 contract, and ``trace_count`` counts down to disable
(-1 = unlimited, Triton's default).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List

_LEVELS = ("OFF", "TIMESTAMPS")


class RequestTracer:
    """Sampled per-request timestamp recording (one Triton trace role)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.trace_level: List[str] = ["OFF"]
        self.trace_rate = 1000
        self.trace_count = -1     # remaining traces; -1 = unlimited
        self.log_frequency = 0    # flush every N records (0 = each one)
        self.trace_file = "trace.json"
        self._seen = 0
        self._pending: List[dict] = []

    # -- settings document (Triton string-valued wire form) --

    def settings(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "trace_level": list(self.trace_level),
                "trace_rate": str(self.trace_rate),
                "trace_count": str(self.trace_count),
                "log_frequency": str(self.log_frequency),
                "trace_file": self.trace_file,
            }

    def update(self, updates: Dict[str, Any]) -> Dict[str, Any]:
        """Apply a POST /v2/trace/setting body; ValueError -> 400."""
        def _int(key, value, minimum):
            try:
                v = int(value)
            except (TypeError, ValueError):
                raise ValueError(f"'{key}' expects an integer") from None
            if v < minimum:
                raise ValueError(f"'{key}' must be >= {minimum}")
            return v

        checked: Dict[str, Any] = {}
        for key, value in updates.items():
            if key == "trace_level":
                if (not isinstance(value, list)
                        or not value
                        or any(v not in _LEVELS for v in value)):
                    raise ValueError(
                        f"'trace_level' expects a list drawn from {_LEVELS}"
                    )
                checked[key] = list(value)
            elif key == "trace_rate":
                checked[key] = _int(key, value, 1)
            elif key == "trace_count":
                checked[key] = _int(key, value, -1)
            elif key == "log_frequency":
                checked[key] = _int(key, value, 0)
            elif key == "trace_file":
                if not isinstance(value, str) or not value:
                    raise ValueError("'trace_file' expects a path string")
                checked[key] = value
            else:
                raise ValueError(f"unknown trace setting '{key}'")
        with self._lock:
            for key, value in checked.items():
                setattr(self, key, value)
            if "trace_rate" in checked:
                self._seen = 0  # restart the sampling phase
        return self.settings()

    # -- sampling + recording --

    def sample(self) -> bool:
        """Count one request; True when this one should be traced
        (every trace_rate-th, while trace_count hasn't run out)."""
        with self._lock:
            if "TIMESTAMPS" not in self.trace_level or \
                    self.trace_count == 0:
                return False
            self._seen += 1
            if (self._seen - 1) % self.trace_rate:
                return False
            if self.trace_count > 0:
                self.trace_count -= 1
            return True

    def record(self, name: str, timestamps: Dict[str, int],
               **fields: Any) -> None:
        """Append one trace record ({name, timestamps: {EVENT: wall ns},
        extra fields}) to trace_file, honoring log_frequency buffering.

        Never raises: an unwritable trace_file disables tracing (logged
        once) instead of propagating into the batcher completion loops —
        Triton likewise never fails an inference on a trace-write error.
        """
        entry = {
            "model": name,
            "timestamps": {k: int(v) for k, v in timestamps.items()},
            **fields,
        }
        with self._lock:
            self._pending.append(entry)
            if len(self._pending) <= self.log_frequency:
                return
            pending, self._pending = self._pending, []
            path = self.trace_file
        self._write(path, pending)

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
            path = self.trace_file
        if pending:
            self._write(path, pending)

    def _write(self, path: str, pending: List[dict]) -> None:
        """Append records; on OSError drop them and turn tracing OFF."""
        try:
            with open(path, "a", encoding="utf-8") as f:
                for e in pending:
                    f.write(json.dumps(e) + "\n")
        except OSError as exc:
            with self._lock:
                self.trace_level = ["OFF"]
                self._pending.clear()
            from ..utils.logging import get_logger

            get_logger("serve").warning(
                "trace_write_failed",
                msg=f"disabling tracing: cannot write {path!r}: {exc}",
            )


# One process-wide tracer, like Triton's global trace settings (per-model
# settings in Triton fall back to the global document; this server keeps
# the global form only).
TRACER = RequestTracer()


def wall_ns_offset() -> int:
    """Offset converting time.perf_counter() seconds to epoch ns
    (Triton trace timestamps are epoch nanoseconds)."""
    return time.time_ns() - int(time.perf_counter() * 1e9)


def trace_batch_item(name: str, enqueue_pc: float, launch_pc: float,
                     done_pc: float, batch_size: int) -> None:
    """Shared batcher hook (DynamicBatcher + NativeBatcher): sample one
    completed request and record its measured queue/compute timestamps
    as epoch ns — Triton's TIMESTAMPS trace level."""
    if not TRACER.sample():
        return
    off = wall_ns_offset()
    TRACER.record(
        name,
        {
            "QUEUE_START": off + int(enqueue_pc * 1e9),
            "COMPUTE_START": off + int(launch_pc * 1e9),
            "COMPUTE_END": off + int(done_pc * 1e9),
        },
        batch_size=batch_size,
    )
