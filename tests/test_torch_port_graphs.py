"""The serving forward replayed from CUDA graphs (`pipeline/graphs.py`).

CPU tests (the tiny pipeline of tests/torch_port_tiny.py): the forward
copies nothing from the host, the pipeline counts every CPU or mesh
forward as eager, the export and the program's forward hooks see the
eager forward's contract, a capture waits out the forwards in flight.

Card tests (marker `card`; they skip where there is no CUDA device, and
the suite's conftest hides it): the certified Lite4 + W32 pipeline, run
on the card with

    python3 -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_port_graphs.py

(`--noconftest`: the conftest imports JAX, which the card has not).
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from human_body_proportion_estimation_tpu_torch.ops import kernels
from human_body_proportion_estimation_tpu_torch.pipeline import graphs
from human_body_proportion_estimation_tpu_torch.pipeline.full import (
    run_stages,
)
from human_body_proportion_estimation_tpu_torch.utils import profiling
from human_body_proportion_estimation_tpu_torch.utils.profiling import (
    StageTimer,
)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")


@pytest.fixture(scope="module")
def tiny():
    from tests.torch_port_tiny import tiny_models

    return tiny_models()


def tiny_images(n):
    from tests.torch_port_tiny import image

    return [image(s)[0] for s in range(n)]


def prepared(pipe, images):
    """The device inputs of one forward of `images` (the first shard)."""
    shards, _ = pipe._prepare(images, 175.0, 0.5)
    return shards[0]


def test_forward_makes_no_tensor_from_host_data(tiny, monkeypatch):
    """The serving forward's constants are buffers: inside `program(...)`
    nothing builds a tensor from host values (a copy to the card that
    waits for the stream, which a CUDA graph's capture refuses)."""
    pipe = tiny.tpipe
    args = prepared(pipe, tiny_images(3))
    want = pipe.program(*args)

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host data in the forward")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    with torch.inference_mode():
        got = pipe.program(*args)
    monkeypatch.undo()
    assert torch.equal(got, want)


def test_cpu_and_mesh_forwards_count_eager(tiny):
    """No graphs on the CPU, nor over a mesh: every forward counts
    `forward_eager` and none `forward_graphed`, one a forward."""
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )

    pipe = tiny.tpipe
    mesh_pipe = InferencePipeline(
        pipe.config, pipe.backend.detector.state_dict(),
        pipe.pose.state_dict(), device="cpu",
        det_config=pipe.backend.detector.config,
        pose_config=pipe.pose.config, dtype=torch.float32,
        mesh=make_mesh(devices=["cpu", "cpu"]))
    images = tiny_images(3)
    for p in (pipe, mesh_pipe):
        assert p.program.graphs is None
        p.stages = StageTimer()
        try:
            for n in (1, 3, 3):
                p.infer_serving(images[:n], 175.0, 0.5)
            st = p.stages.snapshot()
        finally:
            p.stages = None
        assert st["forward_eager"] == {"count": 3, "total": 3}
        assert "forward_graphed" not in st


def test_export_sees_the_eager_forward(tiny, tmp_path):
    """`export_serving_artifact` traces the eager forward: graphs set on
    the program are never called under `torch.export`. (That the restored
    artifact answers as the live forward does is
    `test_torch_port_export.test_export_restore_run_matches_live`.)"""
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        export_serving_artifact,
    )

    class Refuse:
        def replay(self, *args):
            raise AssertionError("torch.export saw the graphs")

    pipe = tiny.tpipe
    pipe.program.graphs = Refuse()
    try:
        export_serving_artifact(pipe, str(tmp_path),
                                batch_size=pipe.config.serve.max_batch)
    finally:
        pipe.program.graphs = None
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "pipeline.pt2"]


def test_forward_pre_hook_sees_the_padded_batch(tiny):
    """`program(...)` stays the call each forward makes: a forward
    pre-hook (the benchmark's `record_forwards`) sees the padded images
    as its first argument."""
    pipe = tiny.tpipe
    seen = []
    handle = pipe.program.register_forward_pre_hook(
        lambda module, args: seen.append(tuple(args[0].shape)))
    try:
        for n in (1, 3):
            pipe.infer_serving(tiny_images(n), 175.0, 0.5)
    finally:
        handle.remove()
    h, w = pipe.config.detector.input_height, pipe.config.detector.input_width
    assert seen == [(1, h, w, 3), (4, h, w, 3)]


def test_run_stages_runs_each_stage_inside_its_context(tiny):
    """The forward's code runs stage by stage inside `enter(stage)`, in
    order, and `outputs` and the packed forward agree."""
    pipe = tiny.tpipe
    args = prepared(pipe, tiny_images(2))
    log = []

    class Enter:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            log.append(("enter", self.name))

        def __exit__(self, *exc):
            log.append(("exit", self.name))

    with torch.inference_mode():
        packed = run_stages(pipe.program.stages(*args, packed=True), Enter)
        out = pipe.program.outputs(*args)
    assert log == [(e, s) for s in ("detector", "crop", "pose", "decode_cm")
                   for e in ("enter", "exit")]
    assert torch.equal(packed[..., 0], out.person_valid.float())
    assert torch.equal(packed[..., 1:12], out.lengths_cm)


def test_a_capture_waits_out_the_forwards_in_flight():
    """`_Gate`: a capture starts once the forwards under way have ended,
    and holds new forwards back until it is done."""
    gate = graphs._Gate()
    events = []
    in_forward, release = threading.Event(), threading.Event()

    def forward(name, hold=None):
        with gate.forward():
            events.append(("in", name))
            if hold is not None:
                in_forward.set()
                hold.wait(10)
            events.append(("out", name))

    def capture():
        with gate.alone():
            events.append(("capture", None))
            time.sleep(0.05)
            events.append(("captured", None))

    first = threading.Thread(target=forward, args=("first", release))
    first.start()
    assert in_forward.wait(10)
    cap = threading.Thread(target=capture)
    cap.start()
    time.sleep(0.05)
    assert ("capture", None) not in events     # the forward holds it off
    late = threading.Thread(target=forward, args=("late",))
    late.start()
    time.sleep(0.05)
    assert ("in", "late") not in events        # the capture is waiting
    release.set()
    for t in (first, cap, late):
        t.join(10)
    assert events == [("in", "first"), ("out", "first"), ("capture", None),
                      ("captured", None), ("in", "late"), ("out", "late")]


def test_the_gate_holds_under_many_threads():
    """16 threads (more than the cores), forwards and captures at random,
    a short switch interval: no capture ever overlaps a forward or
    another capture, and every thread finishes."""
    import random
    import sys

    gate = graphs._Gate()
    inside = {"forward": 0, "capture": 0}
    lock = threading.Lock()
    overlaps = []

    def enter(kind, clash):
        with lock:
            inside[kind] += 1
            if clash():
                overlaps.append(dict(inside))
        time.sleep(0)
        with lock:
            inside[kind] -= 1

    def work(seed):
        rng = random.Random(seed)
        for _ in range(300):
            if rng.random() < 0.1:
                with gate.alone():
                    enter("capture", lambda: inside["forward"]
                          or inside["capture"] > 1)
            else:
                with gate.forward():
                    enter("forward", lambda: inside["capture"])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not overlaps, overlaps[:3]


def test_op_range_is_an_operator_range_inside_the_span():
    """A replay's `op_range` is a range of the operator kind nested in
    its stage's span: the profiler charges an operator's device work to
    the spans around it, and a user annotation's to none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("detector"), \
                profiling.op_range("cuda_graph_replay"):
            torch.ones(3).add_(1)
    events = {e.name: e for e in prof.events()}
    outer, inner = events["hbpe.detector"], events["cuda_graph_replay"]
    assert outer.is_user_annotation and not inner.is_user_annotation
    assert [c.name for c in outer.cpu_children] == ["cuda_graph_replay"]


def test_launches_recorded_while_capturing_are_not_counted():
    """`recording_launches` takes this thread's launches out of the
    counters; `add_launches` counts a replay's."""
    kernels.reset_launch_counts()
    with kernels.recording_launches() as record:
        kernels._count("nms_sweep")
        kernels._count("nms_sweep")
        kernels._count("head_score")
    assert kernels.launch_counts()["nms_sweep"] == 0
    assert dict(record.launches) == {"nms_sweep": 2, "head_score": 1}
    kernels.add_launches(record.launches)
    kernels._count("nms_sweep")
    assert kernels.launch_counts() == {"decode_heatmaps": 0, "head_score": 1,
                                       "nms_sweep": 3}
    kernels.reset_launch_counts()


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def card_pipe():
    """The certified pipeline on the card (or a skip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        load_image_path,
    )

    pipe = InferencePipeline(device="cuda")
    scenes = [load_image_path(os.path.join(DATA, f"scene_{i}.png"))
              for i in range(3)]
    pipe.test_images = scenes + [np.ascontiguousarray(s[:, ::-1])
                                 for s in scenes]
    return pipe


def card_images(pipe, n, shift=0):
    imgs = pipe.test_images
    return [imgs[(i + shift) % len(imgs)] for i in range(n)]


def serve(pipe, images):
    return pipe.infer_serving(images, person_heights=175.0,
                              det_threshold=0.5)


def eager(pipe, images):
    with torch.inference_mode():
        return pipe.program.eager_forward(
            *prepared(pipe, images)).cpu().numpy()[:len(images)]


@pytest.mark.card
def test_graphed_answers_equal_the_eager_forward_at_every_bucket(card_pipe):
    pipe = card_pipe
    pipe.stages = StageTimer()
    try:
        for n in (1, 2, 3, 4, 8, 16):
            images = card_images(pipe, n)
            first = serve(pipe, images)          # eager, then captured
            again = serve(pipe, images)          # replayed
            assert np.array_equal(again, first), n
            assert np.array_equal(again, eager(pipe, images)), n
            assert again[:, :, 0].any(), n       # persons were found
        st = pipe.stages.snapshot()
    finally:
        pipe.stages = None
    assert pipe.program.graphs.buckets() == [1, 2, 4, 8, 16]
    # 4 images replay the bucket that 3 images captured
    assert st["forward_eager"]["total"] == 5
    assert st["forward_graphed"]["total"] == 7


@pytest.mark.card
def test_the_eager_forward_never_waits_for_the_card(card_pipe):
    """`set_sync_debug_mode("error")` raises at any synchronization with
    the card (a host-to-card copy included): none in a B=16 forward."""
    args = prepared(card_pipe, card_images(card_pipe, 16))
    with torch.inference_mode():
        card_pipe.program.eager_forward(*args)          # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = card_pipe.program.eager_forward(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out.shape[0] == 16


@pytest.mark.card
@pytest.mark.parametrize("sizes", [(4, 4), (1, 8)])
def test_two_threads_get_their_own_answers(card_pipe, sizes):
    """Two threads replaying at once, at one bucket and at two, each get
    their single-thread answers in every one of 200 forwards."""
    pipe = card_pipe
    jobs = [card_images(pipe, n, shift) for n, shift in zip(sizes, (0, 3))]
    want = []
    for images in jobs:
        serve(pipe, images)
        want.append(serve(pipe, images))
    assert not np.array_equal(want[0], want[1][:len(want[0])])
    wrong = collections.Counter()

    def run(k):
        for _ in range(100):
            if not np.array_equal(serve(pipe, jobs[k]), want[k]):
                wrong[k] += 1

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not wrong, wrong


@pytest.mark.card
def test_weights_changed_in_place_reach_the_answers(card_pipe):
    """Pose weights changed in place reach the replayed answers; a change
    of the class head, whose packed weights are derived, drops the graphs:
    the next forward runs eagerly, the one after replays the new graphs."""
    pipe = card_pipe
    images = card_images(pipe, 2)
    serve(pipe, images)
    before = serve(pipe, images)
    pose_w = next(pipe.pose.parameters())
    bias = pipe.backend.detector.class_net.predict_pw.bias
    saved = [t.detach().clone() for t in (pose_w, bias)]
    pipe.stages = StageTimer()
    try:
        with torch.no_grad():
            pose_w.mul_(1.5)
        moved = serve(pipe, images)
        assert not np.array_equal(moved, before)
        assert np.array_equal(moved, eager(pipe, images))
        assert pipe.stages.snapshot()["forward_graphed"]["total"] == 1

        with torch.no_grad():
            bias.sub_(30.0)                     # nobody is a person now
        gone = serve(pipe, images)
        assert not gone[:, :, 0].any()
        assert pipe.program.graphs.buckets() == [2]   # dropped, recaptured
        assert np.array_equal(serve(pipe, images), gone)
        st = pipe.stages.snapshot()
        assert st["forward_eager"]["total"] == 1
        assert st["forward_graphed"]["total"] == 2
    finally:
        with torch.no_grad():
            for t, old in zip((pose_w, bias), saved):
                t.copy_(old)
        pipe.stages = None
    serve(pipe, images)
    assert np.array_equal(serve(pipe, images), before)


@pytest.mark.card
def test_a_replay_counts_one_launch_of_each_kernel(card_pipe):
    images = card_images(card_pipe, 4)
    serve(card_pipe, images)
    kernels.reset_launch_counts()
    for _ in range(3):
        serve(card_pipe, images)
    assert kernels.launch_counts() == {"decode_heatmaps": 3,
                                       "head_score": 3, "nms_sweep": 3}


@pytest.mark.card
def test_a_traced_replay_keeps_kernels_under_its_stages(card_pipe,
                                                        tmp_path):
    """Each stage's graph replays inside its span: in a trace of three
    replayed forwards, each `hbpe.detector` range launches (the graph
    launch) one `head_score` and one `nms_sweep` kernel, each
    `hbpe.decode_cm` one `decode_heatmaps`, each `hbpe.pose` none of
    them and the pose's convolutions; the profiler charges device time
    to the detector and pose spans (what the benchmark's
    `detector.device_ms` / `pose.device_ms` read). The trace, not
    `launch_counts` (which a replay adds from its capture), shows that
    the hand-written kernels run in a replayed forward."""
    from torch.autograd import DeviceType

    images = card_images(card_pipe, 4)
    serve(card_pipe, images)
    serve(card_pipe, images)
    with profiling.torch_trace(str(tmp_path)) as prof:
        for _ in range(3):
            serve(card_pipe, images)
    device_ms = collections.defaultdict(list)
    for e in prof.events():
        # each range's host-side event (the profiler adds a device-side
        # one for a range that launched work)
        if e.name in ("hbpe.detector", "hbpe.pose") \
                and e.device_type == DeviceType.CPU:
            device_ms[e.name].append(e.device_time_total / 1e3)
    for name in ("hbpe.detector", "hbpe.pose"):
        assert len(device_ms[name]) == 3, device_ms
        assert min(device_ms[name]) > 1.0, device_ms  # ~6 / 9 ms at B=4
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ran = collections.defaultdict(list)     # correlation -> kernel names
    for e in events:
        if e.get("cat") == "kernel":
            ran[e["args"].get("correlation")].append(e["name"])
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e["args"].get("correlation") in ran]
    ours = ("head_score_kernel", "nms_sweep_kernel",
            "decode_heatmaps_kernel")
    want = {"hbpe.detector": [1, 1, 0], "hbpe.pose": [0, 0, 0],
            "hbpe.decode_cm": [0, 0, 1]}
    for name, counts in want.items():
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation" and e["name"] == name]
        assert len(spans) == 3, name
        for r in spans:
            names = [k for e in launches if e["tid"] == r["tid"]
                     and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]
                     for k in ran[e["args"]["correlation"]]]
            assert [sum(o in k for k in names) for o in ours] == counts, \
                (name, r["ts"])
            if name != "hbpe.decode_cm":
                assert len(names) > 10, name
