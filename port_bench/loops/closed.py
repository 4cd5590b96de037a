"""Closed loop: one caller gives `infer_serving` `batch` pool scenes at a
time, back to back (mix keys "batch", "threshold", "trace_seconds").
The end-to-end metric is `imgs_per_s`; every slot of every row the
window returned is compared."""

from __future__ import annotations

import time

import numpy as np

from port_bench import judge, load, programs
from port_bench.loops import Driven, profiler


def warm_up(program, pipe, pool, heights, c):
    """The one batch size of the window, twice."""
    n = c.mix["batch"]
    for _ in range(2):
        pipe.infer_serving(list(pool[:n]),
                           person_heights=[[h] for h in heights[:n]],
                           det_threshold=c.mix["threshold"])


def drive(program, pipe, state, pool, heights, c, seed, seconds, trace):
    from torch.profiler import record_function

    from port_bench import trace as trace_mod

    mix = c.mix
    batches = load.closed_batches(seed, len(pool), mix["batch"])
    out = []

    def one():
        idx = next(batches)
        with record_function("bench.batch"):
            rows = pipe.infer_serving(
                [pool[i] for i in idx],
                person_heights=[[h] for h in heights[idx]],
                det_threshold=mix["threshold"])
        out.append((idx, rows))

    pipe.stages = programs.stage_timer()
    if pipe.device.type == "cuda":
        import torch

        torch.cuda.synchronize(pipe.device)
    t0 = state.window_start = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one()
    state.window_s = time.perf_counter() - t0
    state.images = len(out) * mix["batch"]
    state.stages = pipe.stages.snapshot()
    if trace:
        n = len(out)
        with profiler() as prof:
            t1 = time.perf_counter()
            with record_function(trace_mod.WINDOW):
                while time.perf_counter() - t1 < mix["trace_seconds"]:
                    one()
        state.trace = trace_mod.summarize(prof, (), t1)
        state.trace["batches"] = len(out) - n
    return Driven({"imgs_per_s": state.images / state.window_s},
                  state.images, 0, out, 0, mix["batch"])


def numbers(answers, ref):
    return judge.packed_rows(np.concatenate([b[0] for b in answers]),
                             np.concatenate([b[1] for b in answers]), ref)


def control_numbers(low, ref):
    low = judge.flat(low)
    return judge.compare(low["valid"], low["lengths"], low["visible"],
                         judge.flat(ref))
