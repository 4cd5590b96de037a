"""Dynamic request batching for the port's pipeline (a copy of the JAX
package's `serve/batching.py`; tracing goes to the port's own tracer).

This is the serving-core role Triton's dynamic batcher plays in the
reference (configured in gitignored config.pbtxt, README :71-80): individual
HTTP requests are coalesced into device batches under a deadline, so the
GPU sees large fused-forward invocations while callers keep request-level
latency guarantees.

Design: a single collector thread owns the device (one in-flight program at
a time keeps HBM bounded and matches single-chip serving); callers submit
work items and block on futures. Batch launch fires when `max_batch` items
are waiting or `batch_timeout_ms` elapsed since the first queued item —
the classic deadline batcher. Per-request metrics (queue wait, batch size,
total latency) feed the /metrics endpoint, an observability gap in the
reference (Triton metrics are explicitly disabled,
`uvicorn_server/start_servers.sh:3`).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, List, Sequence

from human_body_proportion_estimation_tpu_torch.utils import profiling


@dataclass
class WorkItem:
    payload: Any
    future: Future = field(default_factory=Future)
    enqueue_time: float = field(default_factory=time.perf_counter)


class Metrics:
    """Lock-protected rolling serving metrics (counts, latency percentiles,
    batch occupancy)."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=window)
        self._queue_waits = collections.deque(maxlen=window)
        self._batch_sizes = collections.deque(maxlen=window)
        self.requests_total = 0
        self.failures_total = 0
        self.batches_total = 0

    def observe_batch(self, size: int):
        with self._lock:
            self.batches_total += 1
            self._batch_sizes.append(size)

    def observe_request(self, latency_s: float, queue_wait_s: float,
                        failed: bool = False):
        with self._lock:
            self.requests_total += 1
            if failed:
                self.failures_total += 1
            self._latencies.append(latency_s)
            self._queue_waits.append(queue_wait_s)

    @staticmethod
    def _pct(values, q):
        if not values:
            return 0.0
        s = sorted(values)
        idx = min(len(s) - 1, int(round(q / 100 * (len(s) - 1))))
        return s[idx]

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            qw = list(self._queue_waits)
            bs = list(self._batch_sizes)
            return {
                "requests_total": self.requests_total,
                "failures_total": self.failures_total,
                "batches_total": self.batches_total,
                "latency_ms_p50": 1e3 * self._pct(lat, 50),
                "latency_ms_p95": 1e3 * self._pct(lat, 95),
                "latency_ms_p99": 1e3 * self._pct(lat, 99),
                "queue_wait_ms_p95": 1e3 * self._pct(qw, 95),
                "mean_batch_size": (sum(bs) / len(bs)) if bs else 0.0,
            }


class DynamicBatcher:
    """Deadline batcher: coalesce work items, run them through `runner`.

    Args:
        runner: called with the list of payloads of one batch; must return
            one result per payload (exceptions fail the whole batch's
            futures).
        max_batch: device batch cap.
        batch_timeout_ms: max time the first item of a batch waits for
            company before launch.
        queue_depth: back-pressure bound; `submit` raises queue.Full beyond
            it (the HTTP layer maps this to a 503-style error response,
            where the reference would block the event loop instead,
            server.py:109-111).
        stages: an optional `utils.profiling.StageTimer` that each batch
            reports to, under its batch id (`profiling.batch_scope`):
            `batcher_forward` (the runner, whose own stages nest in it)
            and `batcher_answer` (the futures' results). One batch runs
            at a time on the collector thread, so a formed batch never
            waits for a slot: there is no `batcher_slot_wait` here.
    """

    def __init__(
        self,
        runner: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 8,
        batch_timeout_ms: float = 4.0,
        queue_depth: int = 256,
        metrics: Metrics | None = None,
        trace_name: str = "pipeline",
        stages: profiling.StageTimer | None = None,
    ):
        self._runner = runner
        self._stages = stages
        self._max_batch = max_batch
        self._timeout_s = batch_timeout_ms / 1e3
        self._queue: queue.Queue[WorkItem | None] = queue.Queue(queue_depth)
        self.metrics = metrics or Metrics()
        # label for sampled trace records (the Triton trace extension;
        # serve/tracing.py) — the domain pipeline or a registry model name
        self.trace_name = trace_name
        self._stopping = False
        self._thread = threading.Thread(
            target=self._loop, name="hbpe-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, payload: Any) -> Future:
        """Enqueue one payload; returns a Future with its result."""
        if self._stopping:
            raise RuntimeError("batcher is shut down")
        item = WorkItem(payload)
        self._queue.put_nowait(item)  # raises queue.Full on back-pressure
        return item.future

    def infer(self, payload: Any, timeout: float | None = None) -> Any:
        return self.submit(payload).result(timeout)

    def shutdown(self):
        self._stopping = True
        self._queue.put(None)
        self._thread.join(timeout=5)
        # fail anything still queued (items behind the sentinel, or left
        # when the collector exits) so no caller blocks forever on a
        # future that will never resolve; queue.get_nowait is thread-safe
        # against a collector that outlived the join timeout — an item
        # goes to exactly one side either way
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("batcher is shut down")
                )

    # ------------------------------------------------------------------ #

    def _collect(self) -> List[WorkItem]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self._timeout_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._stopping = True
                break
            batch.append(item)
        return batch

    def _loop(self):
        while not self._stopping:
            batch = self._collect()
            if not batch:
                continue
            with profiling.batch_scope(profiling.next_batch_id()):
                self._run(batch)

    def _run(self, batch: List[WorkItem]):
        launch = time.perf_counter()
        self.metrics.observe_batch(len(batch))
        try:
            with profiling.stage_of(self._stages, "batcher_forward"):
                results = self._runner([w.payload for w in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"runner returned {len(results)} results for "
                    f"{len(batch)} payloads"
                )
            with profiling.stage_of(self._stages, "batcher_answer"):
                done = time.perf_counter()
                for w, r in zip(batch, results):
                    # counted and traced before its waiter wakes, so that a
                    # caller reading /metrics or the trace next sees it
                    self.metrics.observe_request(
                        done - w.enqueue_time,
                        launch - w.enqueue_time,
                    )
                    self._maybe_trace(w, launch, done, len(batch))
                    w.future.set_result(r)
        except Exception as e:  # noqa: BLE001 — fail the whole batch
            with profiling.stage_of(self._stages, "batcher_answer"):
                for w in batch:
                    if not w.future.done():
                        w.future.set_exception(e)
                    self.metrics.observe_request(
                        time.perf_counter() - w.enqueue_time,
                        launch - w.enqueue_time,
                        failed=True,
                    )

    def _maybe_trace(self, w: WorkItem, launch: float, done: float,
                     batch_size: int):
        """Triton trace extension: when the global tracer samples this
        request, record its measured queue/compute wall timestamps."""
        from human_body_proportion_estimation_tpu_torch.serve import tracing

        tracing.trace_batch_item(
            self.trace_name, w.enqueue_time, launch, done, batch_size
        )
