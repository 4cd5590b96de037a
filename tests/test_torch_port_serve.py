"""The port's serving edge against the JAX package's, on the CPU.

Both `ServingApp`s run in-process on port 0 over the tiny pipelines of
tests/test_torch_port_pipeline.py (the same flax-init weights on both
sides): the JAX app on the Python `DynamicBatcher` one image a batch (one
compiled bucket), the port's on its `NativeBatcher` built from
`native/serving_core.cpp` into the package's `build/`. The same bodies go
to both; status, `code`, `msg` and keys must be equal, and cm values agree
to the tolerance of `test_slice_infer_bytes_json_matches_jax` (1e-3 rel and
abs) on the segments whose keypoints' heatmap argmax is decisive: top-two
gap > 5e-3 in the port's heatmaps, which agree with the JAX ones to 1e-3,
on person slots whose crop stays off the far image edge (the documented
crop divergence, ROADMAP.md section 3).

Also here: both batchers' semantics as one parametrised test each, the
native core's build location, `parse_multipart`, `StageTimer`, the
logging and trace settings documents, the OpenAPI document and the
server's `main` exits. The registry's `/v2` routes and the gRPC edge are
held against the JAX package's in tests/test_torch_port_registry.py and
tests/test_torch_port_grpc.py.
"""

import http.client
import io
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest

from human_body_proportion_estimation_tpu.serve import tracing as jtracing
from human_body_proportion_estimation_tpu.serve.http import (
    parse_multipart as jparse,
)
from human_body_proportion_estimation_tpu.serve.server import (
    ServingApp as JServingApp,
    create_server as jcreate_server,
)
from human_body_proportion_estimation_tpu.utils import logging as jlogging
from human_body_proportion_estimation_tpu.utils.config import (
    PipelineConfig as JPipelineConfig,
    ServeConfig as JServeConfig,
)
from human_body_proportion_estimation_tpu_torch.ops.proportions import (
    _REQUIRED,
    SEGMENT_NAMES,
)
from human_body_proportion_estimation_tpu_torch.serve import (
    native as tnative,
    tracing as ttracing,
)
from human_body_proportion_estimation_tpu_torch.serve.batching import (
    DynamicBatcher,
)
from human_body_proportion_estimation_tpu_torch.serve.http import (
    parse_multipart as tparse,
)
from human_body_proportion_estimation_tpu_torch.serve.server import (
    ServingApp as TServingApp,
    create_server as tcreate_server,
    main as tmain,
)
from human_body_proportion_estimation_tpu_torch.utils import (
    logging as tlogging,
)
from tests.test_torch_port_pipeline import pipelines  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rel=1e-3, abs=1e-3)
FILE_ROUTE = "/body_proportion_length_estimation_file"
VIDEO_ROUTE = "/body_proportion_length_estimation_video"
STREAM_ROUTE = "/body_proportion_length_estimation_video_stream"


# --------------------------------------------------------------------- #
# helpers


def multipart(fields):
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, (data, filename) in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        disp = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        out.write(disp.encode() + b"\r\n\r\n")
        out.write(data if isinstance(data, bytes) else str(data).encode())
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def request(port, method, path, body=None, ctype=None):
    """(status, raw body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if ctype else {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def get_json(port, path):
    status, data = request(port, "GET", path)
    return status, json.loads(data)


def post_json(port, path, doc):
    status, data = request(port, "POST", path, json.dumps(doc).encode(),
                           "application/json")
    return status, json.loads(data)


def decisive_segments(tpipe, images, gap=5e-3):
    """[n, P, 11] mask of the segments whose keypoints all have a decisive
    heatmap argmax (top-two gap > `gap` in the port's heatmaps) on person
    slots whose crop stays off the far image edges."""
    out = tpipe.infer_images(images, 175.0, det_threshold=0.5,
                             with_heatmaps=True)
    flat = np.sort(out.heatmaps.reshape(*out.heatmaps.shape[:3], -1), -1)
    off_edge = np.all(out.boxes_norm[..., 2:] < 1.0 - 1e-3, -1)
    kp_ok = ((flat[..., -1] - flat[..., -2]) > gap) & off_edge[..., None]
    return np.all(np.where(_REQUIRED, kp_ok[..., None, :], True), -1)


def first_valid_slot(tpipe, image):
    valid = tpipe.infer_images([image], 175.0, det_threshold=0.5).person_valid
    return int(np.argmax(valid[0])) if valid[0].any() else None


def assert_cm_close(got, ref, seg_ok):
    """Two `body_proportion_lengths_(cm)` dicts: the same segment names;
    strings equal and numbers within TOL where the segment is decisive."""
    assert list(got) == list(ref)
    if not ref:
        return 0
    assert list(ref) == SEGMENT_NAMES
    checked = 0
    for s, name in enumerate(SEGMENT_NAMES):
        if not seg_ok[s]:
            continue
        checked += 1
        if isinstance(ref[name], str):
            assert got[name] == ref[name], name
        else:
            assert got[name] == pytest.approx(ref[name], **TOL), name
    return checked


def images():
    """Three 128x128 test images whose first person slot stays off the far
    image edges (where most slots of random-weight detections end up), so
    that the served person's cm values can be compared."""
    return [np.random.default_rng(seed).integers(0, 256, (128, 128, 3),
                                                 dtype=np.uint8)
            for seed in (9, 12, 14)]


def png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def video_clip():
    """6 frames cycling through the 3 test images, in a lossless FFV1 clip
    (a lossy codec moves the noise images' detections to the edge), and
    the frames as cv2 decodes them back (what both servers see)."""
    import tempfile

    import cv2

    from human_body_proportion_estimation_tpu_torch.utils.io import (
        stream_video_bytes,
    )

    path = tempfile.mktemp(suffix=".avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 5.0,
                        (128, 128))
    for i in range(6):
        w.write(images()[i % 3][..., ::-1])
    w.release()
    with open(path, "rb") as fh:
        data = fh.read()
    os.unlink(path)
    frames, _ = stream_video_bytes(data)
    return data, list(frames)


# --------------------------------------------------------------------- #
# the two servers


@pytest.fixture(scope="module")
def servers(pipelines):  # noqa: F811
    jpipe, tpipe = pipelines
    # one image a batch on the JAX side: only the B=1 serving program is
    # compiled; the Python batcher leaves the JAX package's native/ alone
    japp = JServingApp(jpipe, JPipelineConfig(
        serve=JServeConfig(max_batch=1, native_batcher=False)))
    tapp = TServingApp(tpipe)
    assert tapp.native, "the port's native core must build here"
    out = []
    for app, create in ((japp, jcreate_server), (tapp, tcreate_server)):
        server = create(app, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append((server, app))
    yield {"jax": out[0][0].server_address[1],
           "port": out[1][0].server_address[1], "tpipe": tpipe,
           "tapp": tapp}
    for server, app in out:
        server.shutdown()
        app.shutdown()


def both(servers, fn):
    return fn(servers["jax"]), fn(servers["port"])


@pytest.mark.parametrize("method,path", [
    ("GET", "/"), ("GET", "/v2/health/live"), ("GET", "/v2/health/ready"),
    ("GET", "/nope"), ("GET", "/v2/nope"), ("POST", "/nope"),
])
def test_simple_routes_match_jax(servers, method, path):
    ref, got = both(servers, lambda p: request(p, method, path))
    assert got[0] == ref[0]
    assert json.loads(got[1]) == json.loads(ref[1])


def test_file_route_matches_jax(servers):
    img = images()[0]
    body, ctype = multipart({
        "file": (png(img), "person.png"),
        "person_height_in_cm": ("172", None),
        "threshold": ("0.5", None),
    })
    (s_ref, ref), (s_got, got) = both(
        servers, lambda p: request(p, "POST", FILE_ROUTE, body, ctype))
    ref, got = json.loads(ref), json.loads(got)
    assert s_got == s_ref == 200
    assert list(got) == list(ref)
    assert (got["code"], got["msg"]) == (ref["code"], ref["msg"])
    assert ref["msg"] == "human body proportion estimation complete"
    tpipe = servers["tpipe"]
    slot = first_valid_slot(tpipe, img)
    seg_ok = decisive_segments(tpipe, [img])[0, slot]
    assert assert_cm_close(got["body_proportion_lengths_(cm)"],
                           ref["body_proportion_lengths_(cm)"], seg_ok) >= 3


@pytest.mark.parametrize("fields", [
    {"file": (b"not an image", "x.jpg")},
    {"threshold": ("0.5", None)},
    {"file": (b"x", "x.jpg"), "person_height_in_cm": ("tall", None)},
], ids=["bad_image", "missing_file", "bad_height"])
def test_file_route_failures_match_jax(servers, fields):
    body, ctype = multipart(fields)
    ref, got = both(
        servers, lambda p: request(p, "POST", FILE_ROUTE, body, ctype))
    assert got[0] == ref[0] == 200
    assert json.loads(got[1]) == json.loads(ref[1])
    assert json.loads(got[1])["code"] == "failed"


@pytest.fixture(scope="module")
def clip(servers):
    data, frames = video_clip()
    tpipe = servers["tpipe"]
    seg_ok = decisive_segments(tpipe, frames)
    slots = [first_valid_slot(tpipe, f) for f in frames]
    return data, frames, seg_ok, slots


def test_video_route_matches_jax(servers, clip):
    data, frames, seg_ok, slots = clip
    body, ctype = multipart({
        "file": (data, "clip.avi"),
        "person_height_in_cm": ("180", None),
        "threshold": ("0.5", None),
        "frame_stride": ("2", None),
    })
    (s_ref, ref), (s_got, got) = both(
        servers, lambda p: request(p, "POST", VIDEO_ROUTE, body, ctype))
    ref, got = json.loads(ref), json.loads(got)
    assert s_got == s_ref == 200
    assert list(got) == list(ref)
    for key in ("code", "msg", "fps", "frame_stride", "num_frames_processed"):
        assert got[key] == ref[key], key
    assert [f["frame"] for f in got["frames"]] == [0, 2, 4]
    checked = 0
    for g, r in zip(got["frames"], ref["frames"]):
        assert g["frame"] == r["frame"] and g["msg"] == r["msg"]
        i = g["frame"]
        if slots[i] is not None:
            checked += assert_cm_close(g["body_proportion_lengths_(cm)"],
                                       r["body_proportion_lengths_(cm)"],
                                       seg_ok[i, slots[i]])
    assert checked >= 3
    assert list(got["median_body_proportion_lengths_(cm)"]) == list(
        ref["median_body_proportion_lengths_(cm)"])


def test_stream_route_matches_jax(servers, clip):
    data, frames, seg_ok, slots = clip
    body, ctype = multipart({
        "file": (data, "clip.avi"), "threshold": ("0.5", None),
    })
    ref, got = both(
        servers, lambda p: request(p, "POST", STREAM_ROUTE, body, ctype))
    assert got[0] == ref[0] == 200
    ref_lines = [json.loads(x) for x in ref[1].splitlines()]
    got_lines = [json.loads(x) for x in got[1].splitlines()]
    assert len(got_lines) == len(ref_lines) == 1 + len(frames) + 1
    assert got_lines[0] == ref_lines[0]
    assert [f["frame"] for f in got_lines[1:-1]] == list(range(len(frames)))
    for g, r in zip(got_lines[1:-1], ref_lines[1:-1]):
        assert list(g) == list(r) and g["msg"] == r["msg"]
        i = g["frame"]
        if slots[i] is not None:
            assert_cm_close(g["body_proportion_lengths_(cm)"],
                            r["body_proportion_lengths_(cm)"],
                            seg_ok[i, slots[i]])
    g, r = got_lines[-1], ref_lines[-1]
    assert list(g) == list(r) and "frames" not in g
    assert (g["code"], g["msg"], g["num_frames_processed"]) == (
        r["code"], r["msg"], r["num_frames_processed"])


def test_stream_route_garbage_matches_jax(servers):
    body, ctype = multipart({"file": (b"not a video", "x.avi")})
    ref, got = both(
        servers, lambda p: request(p, "POST", STREAM_ROUTE, body, ctype))
    assert got[0] == ref[0] == 200
    assert json.loads(got[1]) == json.loads(ref[1])


def test_settings_documents_match_jax(servers, tmp_path, monkeypatch):
    """GET and POST /v2/logging and /v2/trace/setting with the same
    updates, a rejected one included: the documents (and 400 bodies) are
    equal; a traced request through the port's batcher is recorded."""
    monkeypatch.setattr(jtracing, "TRACER", jtracing.RequestTracer())
    monkeypatch.setattr(ttracing, "TRACER", ttracing.RequestTracer())
    j_before, t_before = jlogging.log_settings(), tlogging.log_settings()
    defaults = {"log_info": True, "log_warning": True, "log_error": True,
                "log_verbose_level": 0, "log_format": "default",
                "log_file": ""}
    trace_file = str(tmp_path / "trace.json")
    try:
        for path, updates in [
            ("/v2/logging", defaults),
            ("/v2/logging", {"log_verbose_level": 1,
                             "log_format": "ISO8601"}),
            ("/v2/logging", {"nope": True}),
            ("/v2/logging", {"log_format": "rfc3339"}),
            ("/v2/logging", defaults),
            ("/v2/trace/setting", {"trace_rate": 0}),
            ("/v2/trace/setting", {"trace_level": ["TIMESTAMPS"],
                                   "trace_rate": "1", "trace_count": 5,
                                   "trace_file": trace_file}),
        ]:
            ref, got = both(servers, lambda p: post_json(p, path, updates))
            assert got == ref, (path, updates)
            ref, got = both(servers, lambda p: get_json(p, path))
            assert got == ref and got[0] == 200, path
        # one request through the port's batcher is traced
        body, ctype = multipart({"file": (png(images()[1]), "p.png")})
        request(servers["port"], "POST", FILE_ROUTE, body, ctype)
        ttracing.TRACER.flush()
        with open(trace_file, encoding="utf-8") as fh:
            rec = json.loads(fh.readline())
        ts = rec["timestamps"]
        assert ts["QUEUE_START"] <= ts["COMPUTE_START"] <= ts["COMPUTE_END"]
        assert ttracing.TRACER.settings()["trace_count"] == "4"
    finally:
        jlogging.configure_logging(j_before)
        tlogging.configure_logging(t_before)


def test_openapi_is_the_jax_document_less_the_registry(servers):
    """Since the registry's routes were ported: the JAX document itself,
    its 9 registry paths included."""
    (s_ref, ref), (s_got, got) = both(
        servers, lambda p: get_json(p, "/openapi.json"))
    assert s_got == s_ref == 200
    registry = [p for p in got["paths"]
                if p.startswith(("/v2/models", "/v2/repository"))]
    assert len(registry) == 9
    assert got == ref
    status, html = request(servers["port"], "GET", "/docs")
    assert status == 200 and b"/openapi.json" in html


def test_v2_metadata_lists_served_extensions(servers):
    (_, ref), (status, got) = both(servers, lambda p: get_json(p, "/v2"))
    assert status == 200 and list(got) == list(ref)
    assert got["extensions"] == ref["extensions"]
    assert got["name"] == "human_body_proportion_estimation_tpu_torch"


def test_metrics_stages_and_health_keys(servers):
    body, ctype = multipart({"file": (png(images()[2]), "p.png")})
    both(servers, lambda p: request(p, "POST", FILE_ROUTE, body, ctype))
    (_, ref), (status, got) = both(servers, lambda p: get_json(p, "/metrics"))
    assert status == 200 and got["engine"] == "native"
    assert ref["engine"] == "python"
    for key in ("request_decode", "host_prepare", "device_upload",
                "device_compute_readback"):
        assert got["stages"][key]["count"] >= 1, key
        assert ref["stages"][key]["count"] >= 1, key
    for key in ("requests_total", "failures_total", "batches_total",
                "latency_ms_p50", "latency_ms_p95", "mean_batch_size"):
        assert key in got, key
    assert got["requests_total"] >= 1 and got["failures_total"] == 0
    (_, ref), (status, got) = both(servers, lambda p: get_json(p, "/health"))
    assert status == 200 and list(got) == list(ref)
    assert got["devices"] == ["cpu"] and got["status"] == "ok"
    assert got["weights"] == ref["weights"] == {"detector": "real",
                                                "pose": "real"}
    assert got["prewarmed"] is False
    assert got["hbm_bytes_in_use"] is None and got["hbm_bytes_limit"] is None


def test_concurrent_requests_coalesce(servers):
    body, ctype = multipart({"file": (png(images()[0]), "p.png"),
                             "threshold": ("0.5", None)})
    port = servers["port"]
    before = get_json(port, "/metrics")[1]
    results = []

    def hit():
        results.append(request(port, "POST", FILE_ROUTE, body, ctype))

    threads = [threading.Thread(target=hit) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({r[1] for r in results}) == 1 and results[0][0] == 200
    after = get_json(port, "/metrics")[1]
    assert after["requests_total"] - before["requests_total"] == 12
    assert after["batches_total"] - before["batches_total"] < 12


# --------------------------------------------------------------------- #
# batchers


def _native(runner, **kw):
    return tnative.NativeBatcher(runner, **kw)


def _python(runner, **kw):
    return DynamicBatcher(runner, **kw)


ENGINES = pytest.mark.parametrize("make", [_python, _native],
                                  ids=["dynamic", "native"])


@ENGINES
def test_batcher_coalesces_and_preserves_order(make):
    seen = []

    def runner(payloads):
        seen.append(len(payloads))
        time.sleep(0.01)
        return [p * 10 for p in payloads]

    b = make(runner, max_batch=4, batch_timeout_ms=30)
    futs = [b.submit(i) for i in range(8)]
    assert [f.result(5) for f in futs] == [i * 10 for i in range(8)]
    assert sum(seen) == 8 and max(seen) >= 2
    b.shutdown()


@ENGINES
def test_batcher_runner_failure_reaches_the_caller(make):
    def runner(payloads):
        raise RuntimeError("boom")

    b = make(runner, max_batch=2, batch_timeout_ms=1)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(1).result(5)
    m = (b.metrics.snapshot()["failures_total"] if make is _python
         else b.metrics_json()["failed"])
    assert m == 1
    b.shutdown()


@ENGINES
def test_batcher_timeout_launches_partial_batch(make):
    b = make(lambda payloads: payloads, max_batch=64, batch_timeout_ms=5)
    t0 = time.perf_counter()
    assert b.submit("x").result(5) == "x"
    assert time.perf_counter() - t0 < 2.0
    b.shutdown()


def test_native_core_builds_only_under_the_port_build_dir(tmp_path):
    """The port compiles native/serving_core.cpp into its own build dir and
    never writes under native/ (whose .so git tracks)."""
    native_dir = os.path.join(REPO, "native")
    lib = os.path.join(native_dir, "libhbpe_serving.so")

    def snapshot():
        with open(lib, "rb") as fh:
            return (sorted(os.listdir(native_dir)), fh.read(),
                    os.stat(lib).st_mtime_ns)

    before = snapshot()
    build_dir = str(tmp_path / "build")
    path = tnative.build_library(build_dir)
    assert os.path.dirname(path) == build_dir
    assert os.listdir(build_dir) == [os.path.basename(path)]
    assert tnative.build_library(build_dir) == path        # cached
    assert snapshot() == before
    pkg_build = os.path.join(REPO, "human_body_proportion_estimation_tpu_torch",
                             "build")
    assert os.path.dirname(tnative.library_path()) == pkg_build


# --------------------------------------------------------------------- #
# small parity checks


_BOUNDARY = "b0undary"


def _body(*parts, close=True):
    out = b""
    for p in parts:
        out += f"--{_BOUNDARY}\r\n".encode() + p + b"\r\n"
    return out + (f"--{_BOUNDARY}--\r\n".encode() if close else b"")


@pytest.mark.parametrize("body,ctype", [
    (_body(b'Content-Disposition: form-data; name="file"; '
           b'filename="a.jpg"\r\n\r\n\x00\x01\xff',
           b'Content-Disposition: form-data; name="h"\r\n\r\n193'),
     f"multipart/form-data; boundary={_BOUNDARY}"),
    (_body(b'Content-Disposition: form-data; name="x"\r\n\r\n1'),
     f'multipart/form-data; boundary="{_BOUNDARY}"; charset=utf-8'),
    (_body(b'Content-Disposition: form-data; name="x"\r\n\r\n1',
           b'Content-Disposition: form-data; name="x"\r\n\r\n2'),
     f"multipart/form-data; boundary={_BOUNDARY}"),
    (_body(b'Content-Disposition: form-data; name="a"\r\n\r\nno close',
           close=False), f"multipart/form-data; boundary={_BOUNDARY}"),
    (_body(b"no header end"), f"multipart/form-data; boundary={_BOUNDARY}"),
    (_body(b'Content-Type: text/plain\r\n\r\nno disposition'),
     f"multipart/form-data; boundary={_BOUNDARY}"),
    (b"garbage", "text/plain"),
    (b"", f"multipart/form-data; boundary={_BOUNDARY}"),
], ids=["file_and_field", "quoted_boundary", "repeated_field",
        "unclosed", "no_header_end", "no_disposition", "no_boundary",
        "empty"])
def test_parse_multipart_matches_jax(body, ctype):
    try:
        ref = jparse(body, ctype)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tparse(body, ctype)
        return
    got = tparse(body, ctype)
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in ref.items()}


def test_stage_timer_snapshot_matches_jax():
    from human_body_proportion_estimation_tpu.utils.profiling import (
        StageTimer as JStageTimer,
    )
    from human_body_proportion_estimation_tpu_torch.utils.profiling import (
        StageTimer,
    )

    snaps = []
    for timer in (JStageTimer(window=3), StageTimer(window=3)):
        for name in ("a", "b", "a", "a", "a"):
            with timer.stage(name):
                pass
        with pytest.raises(KeyError):
            with timer.stage("c"):
                raise KeyError("failures are timed too")
        snaps.append(timer.snapshot())
    ref, got = snaps
    assert {k: (list(v), v["count"]) for k, v in got.items()} == {
        k: (list(v), v["count"]) for k, v in ref.items()}
    assert got["a"]["count"] == 3      # the window keeps the last 3


@pytest.mark.parametrize("argv", [
    ["--bottom-up", "--data-parallel", "2"],
    ["--artifact-dir", "x", "--data-parallel", "2"],
    ["--data-parallel", "2"], ["--detector", "ssd_mobilenet"],
    ["--checkpoint-dir", "x"],
])
def test_server_main_exits_on_options_not_ported(argv, monkeypatch, capsys):
    """Exit code 2 and the ROADMAP item, before any model is built;
    `--data-parallel 2` (item 16, ported) exits so too where fewer than
    two CUDA devices are present (tests/conftest.py hides every GPU),
    naming them."""
    from human_body_proportion_estimation_tpu_torch.serve import server

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(server, "InferencePipeline", no_model)
    with pytest.raises(SystemExit) as exc:
        tmain(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    # the default detector (ssd_mobilenet, item 10) exits before the mesh
    # is built; --bottom-up and --artifact-dir never read the detector
    dp_first = "--data-parallel" in argv and (
        "--bottom-up" in argv or "--artifact-dir" in argv)
    assert ("--data-parallel 2: 2 devices asked for, 0 CUDA devices "
            "available" if dp_first else "ROADMAP.md item") in err


# --------------------------------------------------------------------- #
# shared state of the pipeline under two batches in flight


@pytest.fixture
def fast_switching():
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def run_threads(fn, n=16):
    """fn() on n threads at once; their results."""
    out = [None] * n
    barrier = threading.Barrier(n)

    def work(i):
        barrier.wait()
        out[i] = fn()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_launch_counts_lose_no_update(fast_switching):
    from human_body_proportion_estimation_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    try:
        run_threads(lambda: [kernels._count("nms_sweep")
                             for _ in range(2000)])
        assert kernels.launch_counts()["nms_sweep"] == 16 * 2000
    finally:
        kernels.reset_launch_counts()


def test_kernel_library_loads_once(fast_switching, monkeypatch):
    from human_body_proportion_estimation_tpu_torch.ops import build, kernels

    calls = []

    def slow_load():
        calls.append(1)
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(build, "load_library", slow_load)
    libs = run_threads(kernels._lib)
    assert len(calls) == 1 and all(lib is libs[0] for lib in libs)


def test_packed_head_weights_pack_once(fast_switching, monkeypatch):
    from collections import OrderedDict

    import torch

    from human_body_proportion_estimation_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "_PACKED", OrderedDict())
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3 * 5, 32), generator=gen).to(torch.bfloat16)
    b = torch.randn(3 * 5, generator=gen)
    packs = run_threads(lambda: kernels._packed_head_weights(w, b, 3, 5, 1))
    assert len(kernels._PACKED) == 1
    assert all(p[0] is packs[0][0] and p[1] is packs[0][1] for p in packs)


def test_class_predict_params_made_once(fast_switching, servers,
                                        monkeypatch):
    """The class predict conv's weight and bias reach the head-score kernel
    as views of the parameters themselves, so that the packing of the
    kernel's operands is made once for all threads' forwards."""
    from collections import OrderedDict

    from human_body_proportion_estimation_tpu_torch.ops import kernels

    detector = servers["tpipe"].backend.detector
    conv = detector.class_net.predict_pw
    monkeypatch.setattr(kernels, "_PACKED", OrderedDict())
    a = detector.config.anchors.anchors_per_cell
    c = detector.config.num_classes

    def pack():
        w, b = detector._class_predict_params()
        return kernels._packed_head_weights(w, b, a, c, 0)

    params = run_threads(detector._class_predict_params)
    assert all(p[0].data_ptr() == conv.weight.data_ptr()
               and p[1].data_ptr() == conv.bias.data_ptr() for p in params)
    packs = run_threads(pack)
    assert len(kernels._PACKED) == 1
    assert all(p[0] is packs[0][0] and p[1] is packs[0][1] for p in packs)
