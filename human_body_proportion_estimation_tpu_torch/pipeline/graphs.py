"""The serving forward replayed from CUDA graphs: one capture per batch
bucket, one graph per stage.

A `ServingProgram` on a CUDA device over a `capturable` backend copies
nothing from the host and never waits for the device, and its shapes are
fixed at each padded batch bucket, so its work at a bucket can be recorded
once and replayed: the host then issues four graph launches a forward in
place of about 4 800 kernels (Lite4 + HRNet-W32 at 16 images).
`ForwardGraphs` holds, for each bucket, the forward captured as one graph
per stage of `ServingProgram.stages` (detector, crop, pose, decode_cm
with the packing), always replayed in that order, each inside its stage's
span and an operator's range (`utils.profiling.op_range`), so that a
profile still charges each stage's kernels to `hbpe.<stage>`. Every graph
of every bucket draws on one memory pool: a capture reuses what the
captures before it freed, so the pool holds about the largest bucket's
forward, not the sum of all buckets'. Graphs that share memory must never
run at once, so replays are serialized (below).

The life of a bucket, as `pipeline.host.InferencePipeline` drives it:

  * its first forward runs eagerly (`replay` returns None). That run makes
    cuDNN's choices for the shapes and packs the head weights
    (`ops.kernels`).
  * after that forward's readback, `capture` records the forward at the
    bucket on a side stream, from copies of its inputs, while no other
    forward of the pipeline is between its issue and its readback
    (`forward` marks that section; a capture waits them out and holds new
    ones back), then empties the allocator's cache of what the eager
    forward left there.
  * every later forward at the bucket copies its inputs into the graphs'
    static inputs, replays the four graphs, and copies the packed rows out
    into a tensor of its own. One lock covers these steps, and an event
    recorded after the copy out orders the next replay, of any bucket,
    behind them on whatever stream it runs: no two replays overlap on the
    device, so none reads memory another one writes. The host's part of a
    replay (about 1.5 ms at B=16) is all that the lock serializes; the
    device runs forwards one after another in any case.

What a graph reads stays alive as long as the graph: the program's
parameters and buffers, and the packed head weights its kernel read (the
kernels' own cache of them keeps only the last few). Weights changed in
place reach the answers, since the graphs read the parameters' memory,
with one exception: the packed head weights are derived from the class
head's weight and bias. Where either has changed since a capture (their
version counters), forwards run eagerly and the next capture first drops
every graph. A parameter replaced by another tensor, rather than changed
in place, is not seen: load weights in place (`load_state_dict` does).

Launches of the port's kernels made while capturing are not counted; a
replay counts what its stage captured (`ops.kernels.recording_launches`),
so `launch_counts` sees one launch of each kernel a forward either way.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional

import torch

from human_body_proportion_estimation_tpu_torch.ops import kernels
from human_body_proportion_estimation_tpu_torch.pipeline.full import (
    run_stages,
)
from human_body_proportion_estimation_tpu_torch.utils.profiling import (
    op_range,
    span,
)


class _Gate:
    """Forwards share the device; a capture has it alone: it waits for the
    forwards under way and holds new ones back until it is done."""

    def __init__(self):
        self._cond = threading.Condition()
        self._forwards = 0
        self._capturing = False

    @contextlib.contextmanager
    def forward(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._capturing)
            self._forwards += 1
        try:
            yield
        finally:
            with self._cond:
                self._forwards -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def alone(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._capturing)
            self._capturing = True
            self._cond.wait_for(lambda: self._forwards == 0)
        try:
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._cond.notify_all()


class _Bucket(NamedTuple):
    """The graphs of one bucket: static inputs, (stage, graph, launches)
    in order, the static packed rows, and what the graphs read."""

    inputs: list
    stages: list
    output: torch.Tensor
    keep: tuple


def _key(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


class ForwardGraphs:
    """The CUDA graphs of a `ServingProgram`'s serving forward, one set a
    bucket (the inputs' shapes, dtypes and device)."""

    def __init__(self, program: torch.nn.Module):
        self.program = program
        self._buckets: Dict[tuple, _Bucket] = {}
        # (tensor, version at capture) of what derived state came from
        self._sources: list = []
        self._gate = _Gate()
        self._local = threading.local()
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None           # every bucket's graphs draw on it
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None   # the last replay

    def buckets(self) -> list:
        """The batch sizes that have graphs, in order."""
        return sorted(key[0][0][0] for key in self._buckets)

    def forward(self):
        """A context around one forward from its issue to its readback:
        a capture never overlaps it."""
        return self._gate.forward()

    def replayed(self) -> bool:
        """Whether this thread's last `replay` replayed its graphs."""
        return getattr(self._local, "replayed", False)

    def _stale(self) -> bool:
        return any(kernels.tensor_version(t) != v for t, v in self._sources)

    def replay(self, images, det_threshold, person_heights,
               orig_hw) -> Optional[torch.Tensor]:
        """The packed rows of the forward on these inputs, replayed from
        the graphs of their bucket; None (nothing run) where the bucket
        has no graphs or they are stale."""
        args = (images, det_threshold, person_heights, orig_hw)
        bucket = self._buckets.get(_key(args))
        replayed = bucket is not None and not self._stale()
        self._local.replayed = replayed
        if not replayed:
            return None
        with torch.inference_mode(), torch.cuda.device(images.device), \
                self._lock:
            stream = torch.cuda.current_stream()
            stream.wait_event(self._done)
            for static, a in zip(bucket.inputs, args):
                static.copy_(a)
            for name, graph, launches in bucket.stages:
                with span(name), op_range("cuda_graph_replay"):
                    graph.replay()
                kernels.add_launches(launches)
            out = bucket.output.clone()
            self._done.record(stream)
        return out

    def capture(self, images, det_threshold, person_heights,
                orig_hw) -> None:
        """Capture the forward at the bucket of these inputs (a forward's
        inputs, on the device), unless it has graphs already; first drop
        every graph if they are stale. Call it outside `forward`."""
        args = (images, det_threshold, person_heights, orig_hw)
        key = _key(args)
        with self._gate.alone(), torch.inference_mode(), \
                torch.cuda.device(images.device):
            if self._stale():
                # nothing of the pipeline is in flight: wait for the
                # device before the graphs' pool goes back to the allocator
                torch.cuda.synchronize(images.device)
                self._buckets.clear()
                self._sources = []
                self._pool = None
            if key not in self._buckets:
                self._buckets[key] = self._capture(args)
                # the bucket's forwards draw on the pool from now on: what
                # its eager forward left cached goes back to the device
                torch.cuda.empty_cache()

    def _capture(self, args) -> _Bucket:
        device = args[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._done = torch.cuda.Event()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream, current = self._stream, torch.cuda.current_stream(device)
        inputs = [a.clone() for a in args]
        pool = self._pool
        stages, packed = [], []

        @contextlib.contextmanager
        def into_graph(name):
            graph = torch.cuda.CUDAGraph()
            with kernels.recording_launches() as record:
                graph.capture_begin(pool, capture_error_mode="thread_local")
                try:
                    yield
                finally:
                    graph.capture_end()
            stages.append((name, graph, dict(record.launches)))
            packed.extend(record.packed)

        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            output = run_stages(self.program.stages(*inputs, packed=True),
                                into_graph)
        current.wait_stream(stream)
        seen = {id(t) for t, _ in self._sources}
        for hit in packed:
            for t in hit[:2]:
                if id(t) not in seen:
                    seen.add(id(t))
                    self._sources.append((t, kernels.tensor_version(t)))
        keep = (packed, tuple(self.program.parameters()),
                tuple(self.program.buffers()))
        self._done.record(current)      # the inputs' copies
        return _Bucket(inputs, stages, output, keep)
