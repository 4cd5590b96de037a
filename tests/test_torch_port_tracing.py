"""The port's serving path traced from inside (`utils/profiling.py`): every
`StageTimer` stage is an `hbpe.<name>` profiler range on the thread that
runs it, tagged with its batch; the batchers' slot wait, forward and
answer; the pipeline's issue split from its readback; the padded-rows
counters, held against what the benchmark's forward hook sees.

On the CPU: the tiny port pipeline of tests/torch_port_tiny.py, the
native batcher's core built with g++, `torch.profiler` on the CPU. The
test marked `card` traces the server's app over the certified pipeline
on a CUDA device and skips elsewhere (README: how to run it there)."""

import bisect
import collections
import json
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from human_body_proportion_estimation_tpu_torch.serve.batching import (
    DynamicBatcher,
)
from human_body_proportion_estimation_tpu_torch.serve.native import (
    NativeBatcher,
)
from human_body_proportion_estimation_tpu_torch.utils import profiling
from human_body_proportion_estimation_tpu_torch.utils.profiling import (
    StageTimer,
)

WAIT_S = 60.0


def trace_events(log_dir) -> list:
    """The `hbpe.*` ranges of the `trace.json` that `torch_trace` wrote."""
    with open(log_dir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("hbpe.")]


def batch_of(event):
    """The batch a range carries (its one input), or None."""
    inputs = event["args"].get("Concrete Inputs")
    return int(inputs[0]) if inputs else None


def named(events, name) -> list:
    return sorted((e for e in events if e["name"] == name),
                  key=lambda e: e["ts"])


@pytest.fixture
def card():
    """The CUDA device, or a skip: the suite hides the GPU, so a test
    that takes this runs only as README's card command runs it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny():
    from tests.torch_port_tiny import tiny_models

    return tiny_models()


def test_a_stage_on_a_pool_thread_is_a_range_with_its_batch(tmp_path):
    timer = StageTimer()

    def work(batch):
        with profiling.batch_scope(batch), timer.stage("work"):
            with timer.stage("inner"):
                pass
        with timer.stage("untagged"):
            pass
        return threading.get_native_id()

    with ThreadPoolExecutor(1) as pool:
        with profiling.torch_trace(str(tmp_path)):
            tid = pool.submit(work, 7).result()
    events = trace_events(tmp_path)
    for name in ("hbpe.work", "hbpe.inner"):
        (e,) = named(events, name)
        assert e["tid"] == tid != threading.get_native_id()
        assert batch_of(e) == 7      # the nested stage inherits it
    (e,) = named(events, "hbpe.untagged")
    assert e["tid"] == tid and batch_of(e) is None
    assert profiling.current_batch() is None
    assert {k: v["count"] for k, v in timer.snapshot().items()} == {
        "work": 1, "inner": 1, "untagged": 1}


def test_spans_use_the_binding_torch_profiler_calls():
    """The batch reaches a trace only through torch's private binding:
    where a torch release drops it, this fails, not the serving path."""
    import torch.autograd

    assert profiling._enter_range is \
        torch.autograd._record_function_with_args_enter
    assert profiling._exit_range is \
        torch.autograd._record_function_with_args_exit


def test_spans_without_the_binding_are_ranges_without_a_batch(
        tmp_path, monkeypatch):
    import torch.autograd

    monkeypatch.delattr(torch.autograd, "_record_function_with_args_enter")
    enter, exit_ = profiling._range_ops()
    monkeypatch.setattr(profiling, "_enter_range", enter)
    monkeypatch.setattr(profiling, "_exit_range", exit_)
    with profiling.torch_trace(str(tmp_path)):
        with profiling.batch_scope(3), profiling.span("old"):
            pass
    (e,) = named(trace_events(tmp_path), "hbpe.old")
    assert batch_of(e) is None


def test_counters_show_in_the_snapshot():
    timer = StageTimer(window=2)
    assert timer.snapshot() == {}
    timer.count("rows_run", 4)
    timer.count("rows_run", 16)
    timer.count("rows_real", 3)
    with timer.stage("a"):
        pass
    snap = timer.snapshot()
    assert snap["rows_run"] == {"count": 2, "total": 20}
    assert snap["rows_real"] == {"count": 1, "total": 3}
    assert set(snap["a"]) == {"count", "mean_ms", "p50_ms", "p95_ms"}


def test_counters_and_batch_ids_hold_under_thread_switches():
    """More threads than cores, switching every microsecond: no count is
    lost and no batch id is handed out twice."""
    timer = StageTimer()
    threads, each = 32, 500

    def work(_):
        ids = []
        for _ in range(each):
            timer.count("rows_run", 2)
            ids.append(profiling.next_batch_id())
        return ids

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            ids = [i for got in pool.map(work, range(threads))
                   for i in got]
    finally:
        sys.setswitchinterval(interval)
    assert timer.snapshot()["rows_run"] == {"count": threads * each,
                                            "total": 2 * threads * each}
    assert len(set(ids)) == threads * each


def test_native_batcher_times_each_batch_and_the_slot_wait(tmp_path):
    """One request a batch, one slot: the second batch is formed while the
    first one's forward is held by a gate, so its slot wait covers the end
    of that forward and its own forward starts after the first's answer."""
    timer = StageTimer()
    gate, first_running, second_waits = (threading.Event()
                                         for _ in range(3))
    seen = {}

    def runner(payloads):
        seen[payloads[0]] = profiling.current_batch()
        if payloads == [1]:
            first_running.set()
            assert gate.wait(WAIT_S)
        return payloads

    b = NativeBatcher(runner, max_batch=1, batch_timeout_ms=1.0,
                      pipeline_depth=1, stages=timer)

    class Slot(type(b._inflight)):
        def acquire(self, *args, **kwargs):
            if first_running.is_set():
                second_waits.set()
            return super().acquire(*args, **kwargs)

    b._inflight = Slot(1)
    stopped = False
    try:
        with profiling.torch_trace(str(tmp_path)):
            f1 = b.submit(1)
            assert first_running.wait(WAIT_S)
            f2 = b.submit(2)
            assert second_waits.wait(WAIT_S)
            gate.set()
            assert f1.result(WAIT_S) == 1 and f2.result(WAIT_S) == 2
            b.shutdown()            # every stage of both batches closed
            stopped = True
    finally:
        gate.set()
        if not stopped:
            b.shutdown()
    snap = timer.snapshot()
    for name in ("batcher_slot_wait", "batcher_forward", "batcher_answer"):
        assert snap[name]["count"] == 2, name
    assert seen[1] is not None and seen[2] is not None
    assert seen[1] != seen[2]
    events = trace_events(tmp_path)
    by_batch = {}
    for e in events:
        by_batch.setdefault((e["name"], batch_of(e)), []).append(e)
    (fwd1,) = by_batch[("hbpe.batcher_forward", seen[1])]
    (ans1,) = by_batch[("hbpe.batcher_answer", seen[1])]
    (slot2,) = by_batch[("hbpe.batcher_slot_wait", seen[2])]
    (fwd2,) = by_batch[("hbpe.batcher_forward", seen[2])]
    (slot1,) = by_batch[("hbpe.batcher_slot_wait", seen[1])]
    # the loop thread waits, a pool thread runs and answers
    assert slot1["tid"] == slot2["tid"] != fwd1["tid"] == ans1["tid"]
    assert slot2["ts"] < fwd1["ts"] + fwd1["dur"] \
        <= slot2["ts"] + slot2["dur"]
    assert fwd2["ts"] >= ans1["ts"] + ans1["dur"]


def test_python_batcher_times_forward_and_answer():
    timer = StageTimer()
    inner = []

    def runner(payloads):
        with timer.stage("inner"):
            inner.append(profiling.current_batch())
        return payloads

    b = DynamicBatcher(runner, max_batch=2, batch_timeout_ms=1.0,
                       stages=timer)
    try:
        assert b.infer(1, timeout=WAIT_S) == 1
        assert b.infer(2, timeout=WAIT_S) == 2
    finally:
        b.shutdown()
    snap = timer.snapshot()
    assert snap["batcher_forward"]["count"] == 2
    assert snap["batcher_answer"]["count"] == 2
    assert snap["inner"]["count"] == 2
    assert "batcher_slot_wait" not in snap
    assert None not in inner and len(set(inner)) == 2


def test_infer_serving_splits_issue_from_readback(tiny, tmp_path):
    """`device_issue` and `device_readback` nest in
    `device_compute_readback`, each once a call, their sum within it; the
    model's spans nest in the issue, on the same thread."""
    from tests.torch_port_tiny import image

    pipe = tiny.tpipe
    try:
        for n, bucket in ((1, 1), (3, 4)):
            pipe.stages = StageTimer()
            pipe.infer_serving([image(s)[0] for s in range(n)], 175.0, 0.5)
            st = pipe.stages.snapshot()
            for name in ("host_prepare", "device_upload",
                         "device_compute_readback", "device_issue",
                         "device_readback"):
                assert st[name]["count"] == 1, name
            assert st["device_issue"]["mean_ms"] + \
                st["device_readback"]["mean_ms"] <= \
                st["device_compute_readback"]["mean_ms"]
            assert st["rows_real"] == {"count": 1, "total": n}
            assert st["rows_run"] == {"count": 1, "total": bucket}
        pipe.stages = StageTimer()
        with profiling.torch_trace(str(tmp_path)):
            pipe.infer_serving([image(0)[0]], 175.0, 0.5)
    finally:
        pipe.stages = None
    events = trace_events(tmp_path)
    (env,) = named(events, "hbpe.device_compute_readback")
    (issue,) = named(events, "hbpe.device_issue")
    (back,) = named(events, "hbpe.device_readback")
    (det,) = named(events, "hbpe.detector")

    def inside(inner, outer):
        return (inner["tid"] == outer["tid"]
                and outer["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])

    assert inside(issue, env) and inside(back, env) and inside(det, issue)
    assert issue["ts"] + issue["dur"] <= back["ts"]


def test_padded_rows_match_what_the_forward_hook_sees(tiny):
    """`rows_run - rows_real` over a short run of the server's batcher and
    of direct calls equals the benchmark's count: the rows each forward
    ran minus the pool images it was given."""
    from port_bench import bench
    from tests.torch_port_tiny import image

    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    program = bench.load_file("programs", "edet_lite_hrnet")
    pipe = tiny.tpipe
    pool = np.concatenate([image(s) for s in range(6)])
    forwards = []
    app = ServingApp(pipe)
    handle = program.record_forwards(pipe, pool, forwards)
    try:
        for group in ((0, 1, 2), (3,), (4, 5, 0, 1, 2)):
            futs = [app.batcher.submit({"image": pool[i], "height": 175.0,
                                        "threshold": 0.5}) for i in group]
            for f in futs:
                f.result(timeout=WAIT_S)
        pipe.infer_serving([pool[i] for i in (1, 2, 3)], 175.0, 0.5)
    finally:
        handle.remove()
        app.batcher.shutdown()
        del pipe.infer_serving          # the hook's wrapper
        pipe.stages = None
    st = app.stages.snapshot()
    padded = sum(rows - len(idx) for _, _, rows, idx, _ in forwards)
    assert st["rows_run"]["total"] - st["rows_real"]["total"] == padded
    assert st["rows_run"]["total"] == sum(f[2] for f in forwards)
    assert st["rows_run"]["count"] == len(forwards)
    assert padded > 0                   # 3 images run as a bucket of 4
    assert st["batcher_forward"]["count"] == len(forwards) - 1


def test_chip_smoke_load_summary_reads_stage_times_beside_counters():
    """`/metrics` `stages` holds the row counters beside the stages; the
    smoke run's summary of a load keeps the stages' mean times."""
    import chip_smoke

    timer = StageTimer()
    with timer.stage("host_prepare"):
        pass
    timer.count("rows_run", 4)
    timer.count("rows_real", 3)
    m1 = {"batches_total": 5, "mean_batch_size": 3.0, "latency_ms_p50": 1.0,
          "latency_ms_p95": 2.0, "queue_wait_ms_p95": 0.5,
          "stages": timer.snapshot()}
    out = chip_smoke.load_summary({"batches_total": 2}, m1, 2.0, 9)
    assert set(out["stages_mean_ms"]) == {"host_prepare"}
    assert out["batches"] == 3 and out["mean_batch_size_of_the_load"] == 3.0
    assert out["requests_per_s"] == 4.5


TRACED = ("hbpe.batcher_forward", "hbpe.device_issue", "hbpe.detector",
          "hbpe.pose")


@pytest.mark.card
def test_a_serving_app_traced_on_the_card(card, tmp_path):
    """The server's app (native batcher, two batches in flight) over the
    certified pipeline, four groups of requests under `torch_trace`:
    every forward's `batcher_forward`, `device_issue`, `detector` and
    `pose` ranges sit on a pool thread, carry that forward's batch, and
    launched kernels that ran on the card."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    pipe = InferencePipeline(device=card)
    cfg = pipe.config.detector
    images = np.random.default_rng(0).integers(
        0, 256, (3, cfg.input_height, cfg.input_width, 3), dtype=np.uint8)
    app = ServingApp(pipe)

    def load():
        futs = []
        for _ in range(4):
            futs += [app.batcher.submit({"image": im, "height": 175.0,
                                         "threshold": 0.7})
                     for im in images]
            threading.Event().wait(0.03)
        for f in futs:
            f.result(timeout=WAIT_S)

    try:
        load()                      # warm: cuDNN's first call a shape
        with profiling.torch_trace(str(tmp_path)):
            load()
    finally:
        app.batcher.shutdown()
        pipe.stages = None
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ran = {e["args"].get("correlation") for e in events
           if e.get("cat") == "kernel"}
    launches = collections.defaultdict(list)        # tid -> [ts]
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                e["args"].get("correlation") in ran:
            launches[e["tid"]].append(e["ts"])
    for ts in launches.values():
        ts.sort()
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name") in TRACED]
    forwards = [e for e in ranges if e["name"] == "hbpe.batcher_forward"]
    assert len(forwards) >= 2
    main = threading.get_native_id()
    for e in ranges:
        assert e["tid"] != main, e["name"]
        (outer,) = [f for f in forwards if f["tid"] == e["tid"]
                    and f["ts"] <= e["ts"] <= f["ts"] + f["dur"]]
        assert batch_of(e) is not None
        assert batch_of(e) == batch_of(outer), e["name"]
        ts = launches[e["tid"]]
        first = bisect.bisect_left(ts, e["ts"])
        assert first < len(ts) and ts[first] <= e["ts"] + e["dur"], \
            e["name"]
    for name in TRACED:
        assert len(named(ranges, name)) == len(forwards), name
