"""Open loop: single-image requests submitted at their due times to the
server's batcher, `ServingApp(pipe).batcher` (mix keys "x_knee",
"block_seconds", "threshold", "trace_seconds"; the cell's "knee_per_s").
The end-to-end metrics are `latency_p50_ms` and `latency_p95_ms`, from
each request's due time to its answer; the person of every served answer
is compared."""

from __future__ import annotations

import sys
import time

import numpy as np

from port_bench import judge, load
from port_bench.loops import Driven, profiler

LATE_ANSWER_S = 60.0      # how long past the close an answer is waited for


def warm_up(program, pipe, pool, heights, c):
    """Each bucket of the batcher once, then the batcher itself, whose app
    is then shut down."""
    thr = c.mix["threshold"]
    n = 1
    while n <= pipe.config.serve.max_batch:
        pipe.infer_serving(list(pool[:n]),
                           person_heights=[[h] for h in heights[:n]],
                           det_threshold=thr)
        n *= 2
    app = program.serving_app(pipe)
    futs = [app.batcher.submit({"image": pool[i % len(pool)],
                                "height": float(heights[i % len(pool)]),
                                "threshold": thr})
            for i in range(32)]
    for f in futs:
        f.result(timeout=120)
    app.batcher.shutdown()


def schedule(c, seed, seconds, pool):
    rate = c.mix["x_knee"] * c.cell["knee_per_s"]
    return load.open_schedule(seed, rate, c.mix["block_seconds"], seconds,
                              pool)


def drive(program, pipe, state, pool, heights, c, seed, seconds, trace):
    """Also logs how late the generator ran; `state.late` keeps it."""
    from torch.profiler import record_function

    from port_bench import trace as trace_mod

    mix = c.mix
    thr = mix["threshold"]
    app = program.serving_app(pipe)
    span = seconds + (mix["trace_seconds"] if trace else 0.0)
    due, which = schedule(c, seed, span, len(pool))
    done_at = [None] * len(due)
    answers = [None] * len(due)
    late = np.zeros(len(due))
    futures = []

    def finished(k):
        def cb(fut):
            done_at[k] = time.perf_counter()
            if fut.exception() is None:
                answers[k] = fut.result()
        return cb

    prof = rf = t_traced = None

    def start_trace():
        nonlocal prof, rf, t_traced
        state.stages = app.stages.snapshot()
        prof = profiler()
        prof.start()
        t_traced = time.perf_counter()
        rf = record_function(trace_mod.WINDOW)
        rf.__enter__()

    t0 = state.window_start = time.perf_counter()
    for k, (d, i) in enumerate(zip(due, which)):
        if trace and prof is None and d >= seconds:
            start_trace()
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[k] = time.perf_counter() - (t0 + d)
        try:
            fut = app.batcher.submit({"image": pool[i],
                                      "height": float(heights[i]),
                                      "threshold": thr})
        except Exception as e:  # noqa: BLE001 — a refusal is a failure
            print(f"request {k} refused: {e!r}", file=sys.stderr,
                  flush=True)
            continue
        fut.add_done_callback(finished(k))
        futures.append(fut)
    if trace:
        if prof is None:
            start_trace()
        wait = t0 + span - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rf.__exit__(None, None, None)
        prof.stop()
    deadline = t0 + span + LATE_ANSWER_S
    for fut in futures:
        try:
            fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 — counted below as missing
            pass
    if trace:
        spans = [(f[0], f[1], "bench.forward on a batcher thread")
                 for f in state.forwards]
        state.trace = trace_mod.summarize(prof, spans, t_traced)
    else:
        state.stages = app.stages.snapshot()
    state.batcher = app.batcher.metrics_json()
    app.batcher.shutdown()
    in_window = due < seconds
    lat = np.array([done_at[k] - (t0 + due[k]) for k in range(len(due))
                    if in_window[k] and answers[k] is not None])
    state.window_s = seconds
    state.images = int(len(lat))
    state.late = late[in_window]
    state.latencies = lat
    late = state.late
    print(f"generator late: median {np.median(late) * 1e3:.3f} ms, p99 "
          f"{np.percentile(late, 99) * 1e3:.3f} ms, max "
          f"{late.max() * 1e3:.3f} ms over {len(late)} requests",
          file=sys.stderr, flush=True)
    pairs = [(int(which[k]), answers[k]) for k in range(len(due))
             if answers[k] is not None]
    attempted = int(in_window.sum())
    metrics = {"latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
               "latency_p95_ms": float(np.percentile(lat, 95) * 1e3)}
    # accepted requests whose answer never came (refusals are failures)
    return Driven(metrics, attempted, attempted - state.images, pairs,
                  len(futures) - len(pairs),
                  max((f[2] for f in state.forwards), default=1))


def numbers(answers, ref):
    return judge.served(answers, ref)


def control_numbers(low, ref):
    """The served answer reports each scene's first slot."""
    return judge.compare(low["valid"][:, 0], low["lengths"][:, 0],
                         low["visible"][:, 0], judge.take(
                             ref, np.arange(len(ref["valid"])), 0))
