"""Tracing / profiling hooks: the port of the JAX package's
`utils/profiling.py`.

  * `span` — the program's one kind of profiler range, `hbpe.<name>`,
    tagged with the batch the current thread is serving (`batch_scope`).
  * `StageTimer` — accumulating per-stage wall-time stats and cumulative
    counters for the serving edge's host-side stages (`/metrics`
    `stages`); each stage is also a `span`.
  * `device_time` — the minimum wall time of a call over a few trials,
    each fenced by a host readback of its result (a CUDA launch returns
    before the work is done; reading a value back waits for it).
  * `torch_trace` — a `torch.profiler` trace of a code region on every
    thread, written to a directory (the JAX package's `xla_trace`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Optional

import numpy as np


def _range_ops():
    """(enter, exit) of a profiler user range whose int inputs reach a
    trace that records shapes: the binding that `torch.profiler` itself
    calls (`torch.autograd._record_function_with_args_enter`, private).
    A torch without it gets `record_function`'s ranges, which carry no
    batch (tests/test_torch_port_tracing.py fails then); serving still
    imports and runs."""
    import torch.autograd as autograd
    from torch.profiler import record_function

    try:
        return (autograd._record_function_with_args_enter,
                autograd._record_function_with_args_exit)
    except AttributeError:
        return (lambda name, *inputs: record_function(name).__enter__(),
                lambda handle: handle.__exit__(None, None, None))


_enter_range, _exit_range = _range_ops()
_thread = threading.local()
_batch_ids = itertools.count(1)


def next_batch_id() -> int:
    """A batch id unique in the process (the batchers number their
    batches with it)."""
    return next(_batch_ids)


def current_batch() -> Optional[int]:
    """The batch this thread is serving, or None."""
    return getattr(_thread, "batch", None)


@contextlib.contextmanager
def batch_scope(batch: int):
    """Mark the spans this thread opens inside as batch `batch`'s."""
    outer = current_batch()
    _thread.batch = batch
    try:
        yield
    finally:
        _thread.batch = outer


class span:
    """A profiler range `hbpe.<name>` on the calling thread (a user
    annotation, as `torch.profiler.record_function` opens), whose one
    input is the thread's current batch, if any: a profiler that records
    shapes writes it into the trace as the range's "Concrete Inputs",
    on every thread. `record_function`'s string argument never reaches
    the trace; an int input does (`_range_ops`). A range costs 3.3-6.5 us
    of host time with no profiler running (the host CPUs of two H100
    machines, PERF.md)."""

    __slots__ = ("_name", "_handle")

    def __init__(self, name: str):
        self._name = f"hbpe.{name}"

    def __enter__(self):
        batch = current_batch()
        self._handle = (_enter_range(self._name) if batch is None
                        else _enter_range(self._name, batch))

    def __exit__(self, *exc):
        _exit_range(self._handle)


def stage_of(timer: Optional["StageTimer"], name: str):
    """`timer.stage(name)`, or nothing where there is no timer."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.stage(name)


class StageTimer:
    """Thread-safe accumulating timer: `with timer.stage("decode"): ...`
    keeps the stage's last `window` durations and opens `span("decode")`
    around it, on whatever thread it runs; `timer.count("rows", n)` adds
    to a cumulative counter."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._samples: Dict[str, collections.deque] = {}
        self._counts: Dict[str, list] = {}
        self._window = window

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self._samples.setdefault(
                        name, collections.deque(maxlen=self._window)
                    ).append(dt)

    def count(self, name: str, n: float = 1):
        """Add `n` to counter `name`: its snapshot entry is
        {"count": events, "total": the sum of n}."""
        with self._lock:
            c = self._counts.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += n

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Every stage and counter under its name, in two shapes: a stage
        {"count", "mean_ms", "p50_ms", "p95_ms"} over its last `window`
        durations, a counter {"count": events, "total": the sum}. A
        reader of stage times keeps the entries with "mean_ms"."""
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
            for name, (events, total) in self._counts.items():
                out[name] = {"count": events, "total": total}
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
    `xla_trace` (`jax.profiler.start_trace`). Every thread is recorded,
    so the batcher's threads show their `hbpe.*` spans beside the
    kernels they launched, and shapes are recorded, which puts each
    span's batch into the trace. Yields the profiler, whose
    `key_averages()` the caller may read."""
    import os

    import torch
    from torch.profiler import (
        ProfilerActivity,
        _ExperimentalConfig,
        profile,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True,
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
