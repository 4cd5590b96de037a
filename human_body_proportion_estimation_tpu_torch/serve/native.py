"""ctypes bindings + batcher on the native C++ serving core (the port of the
JAX package's `serve/native.py`).

`NativeBatcher` is a drop-in alternative to the pure-Python
`DynamicBatcher`: the queueing, deadline batching, back-pressure and
latency histograms live in `native/serving_core.cpp` (the role Triton's
C++ scheduler plays for the reference); Python only maps opaque request
ids to payload/future pairs and runs the fused forward on each batch.

The core's source is shared with the JAX package, whose loader rebuilds
the tracked `native/libhbpe_serving.so` in place. The port never writes
under `native/`: it compiles `native/serving_core.cpp` itself, with the
flags of `native/Makefile`, into the package's gitignored `build/` (or where
`utils/compile_cache` points `ops/build.BUILD_DIR`), under a name that
hashes the source and the flags (as `ops/build.py` keys the CUDA kernels).
The build runs at the first `NativeBatcher`, not at import.
"""

from __future__ import annotations

import ctypes
import json
import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Sequence

from human_body_proportion_estimation_tpu_torch.ops import build as _build
from human_body_proportion_estimation_tpu_torch.serve import tracing
from human_body_proportion_estimation_tpu_torch.utils import profiling

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "native", "serving_core.cpp",
)

_lib = None
_lib_lock = threading.Lock()


def library_path(build_dir: str | None = None) -> str:
    """Where the core built from the current source and flags lives (in
    `ops/build.BUILD_DIR` by default)."""
    return _build.cxx_library_path(SOURCE, "libhbpe_serving", build_dir)


def build_library(build_dir: str | None = None) -> str:
    """Compile the native core into `build_dir` (`ops/build.BUILD_DIR` by
    default) unless a library built from the same source and flags is
    there; returns its path."""
    return _build.build_cxx_library(SOURCE, "libhbpe_serving", build_dir)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.hbpe_core_create.restype = ctypes.c_void_p
            lib.hbpe_core_create.argtypes = [
                ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ]
            lib.hbpe_core_destroy.argtypes = [ctypes.c_void_p]
            lib.hbpe_core_submit.restype = ctypes.c_int
            lib.hbpe_core_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.hbpe_core_next_batch.restype = ctypes.c_int
            lib.hbpe_core_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int, ctypes.c_double,
            ]
            lib.hbpe_core_complete.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ]
            lib.hbpe_core_shutdown.argtypes = [ctypes.c_void_p]
            lib.hbpe_core_queue_size.restype = ctypes.c_int
            lib.hbpe_core_queue_size.argtypes = [ctypes.c_void_p]
            lib.hbpe_core_metrics_json.restype = ctypes.c_int
            lib.hbpe_core_metrics_json.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            _lib = lib
    return _lib


class NativeBatcher:
    """Deadline batcher over the C++ core; same surface as DynamicBatcher."""

    def __init__(
        self,
        runner: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 8,
        batch_timeout_ms: float = 4.0,
        queue_depth: int = 256,
        pipeline_depth: int = 2,
        trace_name: str = "pipeline",
        stages: profiling.StageTimer | None = None,
    ):
        """`pipeline_depth`: number of batches allowed in flight at once.
        2 lets batch N+1's host work (prepare, upload) overlap batch N's
        device compute (both run on the same CUDA stream, so the device
        executes them in order and results stay correct); 1 reproduces
        strictly serial execution.

        `stages`: an optional `utils.profiling.StageTimer` that each batch
        reports to, under its batch id (`profiling.batch_scope`):
        `batcher_slot_wait` (loop thread: formed, until one of the
        `pipeline_depth` slots is free), `batcher_forward` (pool thread:
        the runner, whose own stages nest in it) and `batcher_answer`
        (the core's completion and the futures' results)."""
        self._lib = load_library()
        self._core = self._lib.hbpe_core_create(
            max_batch, batch_timeout_ms, queue_depth
        )
        # label for sampled trace records (the Triton trace extension,
        # serve/tracing.py)
        self.trace_name = trace_name
        self._runner = runner
        self._stages = stages
        self._max_batch = max_batch
        self._pending: Dict[int, tuple] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0
        # runner exceptions (actual failed requests) — the core's "rejected"
        # counter only tracks back-pressure, so /metrics needs this separately
        self._failures = 0
        self._stopping = False
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, pipeline_depth),
            thread_name_prefix="native-batch-exec",
        )
        self._inflight = threading.Semaphore(max(1, pipeline_depth))
        self._thread = threading.Thread(
            target=self._loop, name="native-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, payload: Any) -> Future:
        fut: Future = Future()
        with self._pending_lock:
            self._next_id += 1
            rid = self._next_id
            self._pending[rid] = (payload, fut, time.perf_counter())
        rc = self._lib.hbpe_core_submit(self._core, rid)
        if rc != 0:
            with self._pending_lock:
                self._pending.pop(rid, None)
            if rc == -1:
                raise queue.Full("native queue at capacity")
            raise RuntimeError("native core is shut down")
        return fut

    def infer(self, payload: Any, timeout: float | None = None) -> Any:
        return self.submit(payload).result(timeout)

    def metrics_json(self) -> dict:
        buf = ctypes.create_string_buffer(4096)
        n = self._lib.hbpe_core_metrics_json(self._core, buf, 4096)
        m = json.loads(buf.value.decode()) if n > 0 else {}
        m["failed"] = self._failures
        return m

    def shutdown(self):
        self._stopping = True
        self._lib.hbpe_core_shutdown(self._core)
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)
        self._lib.hbpe_core_destroy(self._core)

    # ------------------------------------------------------------------ #

    def _execute(self, batch: int, batch_ids: List[int], items: List[tuple]):
        try:
            with profiling.batch_scope(batch):
                self._run(batch_ids, items)
        finally:
            self._inflight.release()

    def _run(self, batch_ids: List[int], items: List[tuple]):
        launch = time.perf_counter()
        payloads = [it[0] for it in items]
        results = None
        error = None
        try:
            with profiling.stage_of(self._stages, "batcher_forward"):
                results = self._runner(payloads)
            if len(results) != len(items):
                # a short batch would silently truncate the zip below and
                # leave the tail futures unresolved forever (callers hang
                # on infer() with the default timeout=None)
                raise RuntimeError(
                    f"runner returned {len(results)} results for "
                    f"{len(items)} payloads"
                )
        except Exception as e:  # noqa: BLE001
            error = e
            # pipelined batches fail from separate pool threads; the
            # unguarded += would lose increments
            with self._pending_lock:
                self._failures += len(items)
        with profiling.stage_of(self._stages, "batcher_answer"):
            # record metrics BEFORE waking waiters so a caller reading
            # /metrics right after result() sees its own completion
            done = time.perf_counter()
            n = len(items)
            ids = (ctypes.c_uint64 * n)(*batch_ids)
            lats = (ctypes.c_double * n)(
                *[(done - it[2]) * 1e3 for it in items]
            )
            self._lib.hbpe_core_complete(self._core, ids, n, lats)
            if error is not None:
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(error)
            else:
                for (_, fut, enq), r in zip(items, results):
                    # traced before its waiter wakes, as the metrics are
                    tracing.trace_batch_item(
                        self.trace_name, enq, launch, done, len(items)
                    )
                    fut.set_result(r)

    def _loop(self):
        ids = (ctypes.c_uint64 * self._max_batch)()
        while not self._stopping:
            n = self._lib.hbpe_core_next_batch(
                self._core, ids, self._max_batch, 100.0
            )
            if n <= 0:
                continue
            batch_ids = [int(ids[i]) for i in range(n)]
            with self._pending_lock:
                items = [self._pending.pop(i) for i in batch_ids]
            batch = profiling.next_batch_id()
            with profiling.batch_scope(batch), profiling.stage_of(
                    self._stages, "batcher_slot_wait"):
                self._inflight.acquire()
            if self._stopping:
                self._inflight.release()
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(RuntimeError("shutting down"))
                break
            self._pool.submit(self._execute, batch, batch_ids, items)
