"""The port's gRPC edge against the JAX package's, on the CPU: the
`hbpe.Inference` service and the stock KServe `GRPCInferenceService` on
one port each side, over the tiny models of tests/torch_port_tiny.py (the
same weights, float32 on both sides).

The JAX server's domain pipeline runs the score-kernel detector (Pallas in
interpret mode) one image a batch, its registry the canonical f32
detector, as the port does. Answers must match: status codes and messages
exactly, documents but for the runtime's name, tensors to 1e-3, cm values
as tests/test_torch_port_serve.py compares them (decisive segments, 1e-3).
Also here: the wire copies are the JAX package's bytes, the BYTES framing
and classification rows equal the JAX package's, the server's `main`
refuses `--grpc-port` without grpc, and one quick `serve/perf` level.
"""

import dataclasses
import filecmp
import os

import grpc
import numpy as np
import pytest

from google.protobuf.json_format import MessageToDict

from human_body_proportion_estimation_tpu.serve import (
    kserve_grpc as jkserve,
)
from human_body_proportion_estimation_tpu.serve.grpc_server import (
    GrpcClient as JGrpcClient,
    create_grpc_server as jcreate_grpc_server,
)
from human_body_proportion_estimation_tpu.serve.kserve_grpc import (
    KServeClient as JKServeClient,
)
from human_body_proportion_estimation_tpu.serve.server import (
    ServingApp as JServingApp,
)
from human_body_proportion_estimation_tpu.utils.config import (
    ServeConfig as JServeConfig,
)
from human_body_proportion_estimation_tpu_torch.serve import (
    kserve_pb2 as kpb,
    wire,
)
from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
    GrpcClient,
    create_grpc_server,
    infer_tensor_to_np,
    np_to_infer_tensor,
)
from human_body_proportion_estimation_tpu_torch.serve.kserve_grpc import (
    KServeClient,
)
from human_body_proportion_estimation_tpu_torch.serve.server import (
    ServingApp as TServingApp,
)
from tests.test_torch_port_serve import (
    assert_cm_close,
    decisive_segments,
    first_valid_slot,
    images,
    png,
    video_clip,
)
from tests.torch_port_tiny import (
    PORTED,
    image,
    jax_pipeline,
    jax_registry,
    modified_inputs,
    tiny_models,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-3)
ENSEMBLE = "ensemble_edet4_person_det_pose"


@pytest.fixture(scope="module")
def servers():
    """The JAX and the port gRPC servers on port 0 (one image a batch on
    the JAX side: one compiled serving program)."""
    m = tiny_models()
    japp = JServingApp(jax_pipeline(m), dataclasses.replace(
        m.jcfg, serve=JServeConfig(max_batch=1, native_batcher=False)))
    japp._registry = jax_registry(m)
    tapp = TServingApp(m.tpipe)
    out, stop = {"tpipe": m.tpipe, "tapp": tapp}, []
    for key, app, create in (("jax", japp, jcreate_grpc_server),
                             ("port", tapp, create_grpc_server)):
        server, port = create(app, "127.0.0.1", 0)
        server.start()
        stop.append((server, app))
        out[key] = f"127.0.0.1:{port}"
    out["clients"] = (JGrpcClient(out["jax"]), GrpcClient(out["port"]))
    out["kclients"] = (JKServeClient(out["jax"]), KServeClient(out["port"]))
    yield out
    for c in (*out["clients"], *out["kclients"]):
        c.close()
    for server, app in stop:
        server.stop(0)
        app.shutdown()


def both(servers, fn, kserve=False):
    ref, got = servers["kclients" if kserve else "clients"]
    return fn(ref), fn(got)


def status_of(fn):
    """The gRPC status code and details fn() fails with (None if it does
    not fail)."""
    try:
        fn()
    except grpc.RpcError as e:
        return e.code(), e.details()
    return None


def same_error(servers, fn, kserve=False):
    ref, got = both(servers, lambda c: status_of(lambda: fn(c)), kserve)
    assert got == ref and got is not None
    return got


# --------------------------------------------------------------------- #
# the wire copies


@pytest.mark.parametrize("name", ["hbpe.proto", "hbpe_pb2.py",
                                  "kserve.proto", "kserve_pb2.py"])
def test_wire_schema_files_are_the_jax_package_copies(name):
    jax_dir = os.path.join(REPO, "human_body_proportion_estimation_tpu",
                           "serve")
    port_dir = os.path.join(REPO,
                            "human_body_proportion_estimation_tpu_torch",
                            "serve")
    assert filecmp.cmp(os.path.join(jax_dir, name),
                       os.path.join(port_dir, name), shallow=False)


@pytest.mark.parametrize("arr", [
    np.random.default_rng(6).random((2, 3, 4)).astype(np.float32),
    np.random.default_rng(6).integers(0, 256, (1, 5, 5, 3), dtype=np.uint8),
    np.array([3], np.int64),
], ids=["f32", "u8", "i64"])
def test_wire_tensor_roundtrip_matches_jax(arr):
    from human_body_proportion_estimation_tpu.serve.grpc_server import (
        np_to_infer_tensor as jnp_to_infer_tensor,
    )

    t = np_to_infer_tensor("x", arr)
    assert t.SerializeToString() == jnp_to_infer_tensor(
        "x", arr).SerializeToString()
    back = infer_tensor_to_np(t)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    t.raw_data = t.raw_data[:-1]
    with pytest.raises(ValueError, match="raw bytes"):
        infer_tensor_to_np(t)


def test_bytes_framing_and_classification_match_jax():
    rows = [b"", b"a", bytes(range(256)), "é".encode()]
    raw = wire.serialize_bytes_tensor(rows)
    assert raw == jkserve.serialize_bytes_tensor(rows)
    assert wire.deserialize_bytes_tensor(raw) == rows
    for bad in (raw[:-1], raw[:2]):
        with pytest.raises(ValueError) as exc:
            wire.deserialize_bytes_tensor(bad)
        with pytest.raises(ValueError, match=str(exc.value)):
            jkserve.deserialize_bytes_tensor(bad)
    for arr in (np.array([[0.5, 2.0, 2.0, -1.0]], np.float32),
                np.array([[True, False, True]]), np.array(7, np.uint8),
                np.arange(12, dtype=np.uint16).reshape(2, 6)):
        np.testing.assert_array_equal(
            wire._classification_rows(arr, 3),
            jkserve._classification_rows(arr, 3))


# --------------------------------------------------------------------- #
# hbpe.Inference: the domain RPCs


def test_estimate_matches_jax(servers):
    tpipe = servers["tpipe"]
    checked = 0
    for img in images():
        ref, got = both(servers, lambda c: c.estimate(png(img), 172, 0.5))
        assert list(got) == list(ref)
        assert (got["code"], got["msg"]) == (ref["code"], ref["msg"])
        slot = first_valid_slot(tpipe, img)
        if slot is None:
            continue
        seg_ok = decisive_segments(tpipe, [img])[0, slot]
        checked += assert_cm_close(got["body_proportion_lengths_(cm)"],
                                   ref["body_proportion_lengths_(cm)"],
                                   seg_ok)
    assert checked >= 3
    ref, got = both(servers, lambda c: c.estimate(b"not an image"))
    assert got == ref and got["code"] == "failed"


def test_estimate_video_and_its_stream_match_jax(servers):
    data, frames = video_clip()
    ref, got = both(servers, lambda c: c.estimate_video(
        data, 180, 0.5, frame_stride=2))
    for key in ("code", "msg", "fps", "frame_stride", "num_frames_processed"):
        assert got[key] == ref[key], key
    assert [f["frame"] for f in got["frames"]] == [0, 2, 4]
    assert [f["msg"] for f in got["frames"]] == [
        f["msg"] for f in ref["frames"]]
    ref, got = both(servers, lambda c: list(c.estimate_video_stream(
        data, 180, 0.5)))
    assert [k for k, _ in got] == [k for k, _ in ref] == (
        ["header"] + ["frame"] * len(frames) + ["summary"])
    assert got[0] == ref[0]
    assert [v["frame"] for k, v in got if k == "frame"] == list(
        range(len(frames)))
    g, r = got[-1][1], ref[-1][1]
    assert g["frames"] == r["frames"] == []
    assert (g["code"], g["msg"], g["num_frames_processed"]) == (
        r["code"], r["msg"], r["num_frames_processed"])


def test_garbage_video_gives_one_failed_summary_like_jax(servers):
    ref, got = both(servers, lambda c: list(c.estimate_video_stream(
        b"not a video")))
    assert got == ref
    assert [k for k, _ in got] == ["summary"]
    assert got[0][1]["code"] == "failed"
    ref, got = both(servers, lambda c: c.estimate_video(b"not a video"))
    assert got == ref and got["code"] == "failed"


def test_health_and_server_metadata(servers):
    ref, got = both(servers, lambda c: c.health())
    assert list(got) == list(ref) and got["status"] == "ok"
    assert got["devices"] == ["cpu"]
    assert got["weights"] == {"detector": "real", "pose": "real"}
    ref, got = both(servers, lambda c: c.server_metadata())
    assert got["extensions"] == ref["extensions"]
    assert got["name"] == "human_body_proportion_estimation_tpu_torch"


# --------------------------------------------------------------------- #
# hbpe.Inference: the repository RPCs


def test_hbpe_repository_documents_match_jax(servers):
    ref, got = both(servers, lambda c: c.repository_index())
    assert [r["name"] for r in got] == sorted(PORTED)
    for doc in ("model_metadata", "model_config"):
        for name in PORTED:
            ref, got = both(servers, lambda c: getattr(c, doc)(name))
            assert got.pop("platform").startswith("pytorch")
            ref.pop("platform")
            assert got == ref, (doc, name)
    assert both(servers, lambda c: c.model_ready("hrnet", model_version="1")
                ) == (True, True)
    for name in ("yolov5m", "nope"):
        code, _ = same_error(servers, lambda c: c.model_metadata(name))
        assert code == grpc.StatusCode.NOT_FOUND
    same_error(servers, lambda c: c.model_config("hrnet", model_version="7"))
    same_error(servers, lambda c: c.model_ready("ssd_mobilenet"))
    same_error(servers, lambda c: c.load_model("higherhrnet"))


def test_hbpe_model_infer_matches_jax(servers):
    x = np.random.default_rng(0).random((2, 3, 64, 64), np.float32)
    ref, got = both(servers, lambda c: c.infer("hrnet", {"input": x}))
    np.testing.assert_allclose(got["output"], ref["output"], **TOL)
    inputs = modified_inputs(image(12), 0.5)
    ref, got = both(servers, lambda c: c.infer(
        ENSEMBLE, inputs, ["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"]))
    assert list(got) == ["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"]
    np.testing.assert_allclose(got["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"],
                               ref["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"], **TOL)
    for name, inp in (("nope", {"input": x}), ("yolov5s", {"input": x}),
                      ("hrnet", {"wrong": x}),
                      ("hrnet", {"input": x.astype(np.float64)})):
        same_error(servers, lambda c: c.infer(name, inp))


def test_hbpe_load_unload_and_statistics_match_jax(servers):
    assert both(servers, lambda c: c.unload_model("hrnet")) == (
        {"name": "hrnet", "loaded": False},) * 2
    assert both(servers, lambda c: c.load_model("hrnet")) == (
        {"name": "hrnet", "loaded": True},) * 2
    ref, got = both(servers, lambda c: c.model_statistics("hrnet"))
    (g,), (r,) = got["model_stats"], ref["model_stats"]
    assert sorted(g) == sorted(r) and g["name"] == "hrnet"
    assert sorted(g["inference_stats"]) == sorted(r["inference_stats"])
    same_error(servers, lambda c: c.model_statistics("hrnet",
                                                     model_version="9"))


def test_hbpe_stream_infer_errors_in_band_with_the_request_id(servers):
    x = np.random.default_rng(3).random((1, 3, 64, 64), np.float32)
    requests = [
        {"model_name": "hrnet", "inputs": {"input": x}, "id": "a"},
        {"model_name": "nope", "inputs": {"input": x}, "id": "bad"},
        {"model_name": "hrnet", "inputs": {"wrong": x}, "id": "badtensor"},
        {"model_name": "hrnet", "inputs": {"input": x[:, :, ::-1].copy()},
         "id": "b"},
    ]
    ref, got = both(servers, lambda c: list(c.stream_infer(requests)))
    assert [i["id"] for i in got] == [i["id"] for i in ref] == [
        "a", "bad", "badtensor", "b"]
    for g, r in zip(got, ref):
        assert g["error"] == r["error"]
        if r["outputs"] is not None:
            np.testing.assert_allclose(g["outputs"]["output"],
                                       r["outputs"]["output"], **TOL)


def test_hbpe_settings_rpcs_match_jax(servers):
    from human_body_proportion_estimation_tpu_torch.utils import logging

    before = logging.log_settings()
    try:
        ref, got = both(servers, lambda c: c.get_log_settings())
        assert got == ref
        ref, got = both(servers, lambda c: c.get_trace_settings())
        assert got == ref
        for bad in ("[1]", "{nope"):
            code, _ = same_error(servers, lambda c: c._log_settings(
                c_pb(c).LogSettingsRequest(updates_json=bad)))
            assert code == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        logging.configure_logging(before)


def c_pb(client):
    """The protobuf module of a client's package."""
    import importlib

    return importlib.import_module(
        type(client).__module__.rsplit(".", 1)[0] + ".hbpe_pb2")


# --------------------------------------------------------------------- #
# the KServe GRPCInferenceService


def _doc(msg):
    d = MessageToDict(msg, preserving_proto_field_name=True)
    d.get("config", d).pop("platform", None)
    d.get("config", d).pop("backend", None)
    return d


def test_kserve_server_and_model_documents_match_jax(servers):
    ref, got = both(servers, lambda c: (c.is_server_live(),
                                        c.is_server_ready()), kserve=True)
    assert got == ref == (True, True)
    ref, got = both(servers, lambda c: c.get_server_metadata(), kserve=True)
    assert list(got.extensions) == list(ref.extensions)
    for name in PORTED:
        ref, got = both(servers, lambda c: c.get_model_metadata(name),
                        kserve=True)
        assert got.platform.startswith("pytorch")
        assert _doc(got) == _doc(ref), name
        ref, got = both(servers, lambda c: c.get_model_config(name),
                        kserve=True)
        assert got.config.backend == "pytorch"
        assert _doc(got) == _doc(ref), name
    ref, got = both(servers, lambda c: [MessageToDict(m) for m in
                                        c.get_model_repository_index()],
                    kserve=True)
    assert got == ref
    for name in ("higherhrnet", "nope"):
        code, _ = same_error(servers, lambda c: c.get_model_metadata(name),
                             kserve=True)
        assert code == grpc.StatusCode.NOT_FOUND
        same_error(servers, lambda c: c.is_model_ready(name), kserve=True)


@pytest.mark.parametrize("name", ["hrnet", "edetlite4", ENSEMBLE])
def test_kserve_model_infer_raw_contents_matches_jax(servers, name):
    """tritonclient's wire form: raw_input_contents in, raw outputs back."""
    inputs = ({"input": np.random.default_rng(1).random(
        (3, 3, 64, 64), np.float32)} if name == "hrnet"
        else {"image": image(12, (150, 200))} if name == "edetlite4"
        else modified_inputs(image(12), 0.5))
    ref, got = both(servers, lambda c: c.infer(name, inputs, request_id="r7"),
                    kserve=True)
    assert list(got) == list(ref)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


def test_kserve_typed_contents_and_classification_match_jax(servers):
    x = np.random.default_rng(2).random((1, 3, 64, 64), np.float32)
    responses = []
    for client in servers["kclients"]:
        req = kpb.ModelInferRequest(model_name="hrnet", id="typed")
        t = req.inputs.add(name="input", datatype="FP32", shape=x.shape)
        t.contents.fp32_contents.extend(x.ravel().tolist())
        out = req.outputs.add(name="output")
        out.parameters["classification"].int64_param = 4
        responses.append(client._model_infer(req))
    ref, got = responses
    assert got.id == ref.id == "typed" and got.model_version == "1"
    assert [(o.name, o.datatype, list(o.shape)) for o in got.outputs] == [
        (o.name, o.datatype, list(o.shape)) for o in ref.outputs] == [
        ("output", "BYTES", [1, 4])]
    rows_g = wire.deserialize_bytes_tensor(got.raw_output_contents[0])
    rows_r = wire.deserialize_bytes_tensor(ref.raw_output_contents[0])
    for g, r in zip(rows_g, rows_r):
        gv, gi = g.decode().split(":")
        rv, ri = r.decode().split(":")
        assert gi == ri and float(gv) == pytest.approx(float(rv), abs=1e-3)


def test_kserve_infer_errors_match_jax(servers):
    x = np.zeros((1, 3, 64, 64), np.float32)
    for call in (
        lambda c: c.infer("nope", {"input": x}),
        lambda c: c.infer("ssd_mobilenet", {"image": image(0)}),
        lambda c: c.infer("hrnet", {"input": x.astype(np.float16)}),
        lambda c: c.infer("hrnet", {"input": np.array([b"x"], object)}),
    ):
        same_error(servers, call, kserve=True)
    for client in servers["kclients"]:
        req = KServeClient._build_request("hrnet", {"input": x}, None, "", "")
        req.raw_input_contents.append(b"extra")
        assert status_of(lambda: client._model_infer(req))[0] == \
            grpc.StatusCode.INVALID_ARGUMENT


def test_kserve_stream_errors_carry_the_request_id(servers):
    x = np.random.default_rng(4).random((1, 3, 64, 64), np.float32)
    requests = [
        {"model_name": "hrnet", "inputs": {"input": x}, "id": "one"},
        {"model_name": "yolov5m", "inputs": {"images": x}, "id": "two"},
        {"model_name": "hrnet", "inputs": {"input": x.astype(np.float64)},
         "id": "three"},
    ]
    ref, got = both(servers, lambda c: list(c.stream_infer(requests)),
                    kserve=True)
    assert [(i["id"], i["error"]) for i in got] == [
        (i["id"], i["error"]) for i in ref]
    assert got[1]["outputs"] is None and "yolov5m" in got[1]["error"]
    np.testing.assert_allclose(got[0]["outputs"]["output"],
                               ref[0]["outputs"]["output"], **TOL)


def test_kserve_repository_and_statistics_match_jax(servers):
    for client in servers["kclients"]:
        for name in PORTED:
            client.load_model(name)
        client.unload_model(ENSEMBLE, unload_dependents=True)
    ref, got = both(servers, lambda c: c.get_model_repository_index(),
                    kserve=True)
    assert [MessageToDict(m) for m in got] == [MessageToDict(m) for m in ref]
    loaded = {r["name"]: r["loaded"]
              for r in servers["tapp"].registry.index()}
    assert loaded == {"edetlite4": True, "edetlite4_modified": False,
                      ENSEMBLE: False, "hrnet": False}
    same_error(servers, lambda c: c.load_model("yolov5s"), kserve=True)
    ref, got = both(servers, lambda c: c.get_inference_statistics("hrnet"),
                    kserve=True)
    assert got.model_stats[0].name == "hrnet"
    assert sorted(MessageToDict(got.model_stats[0])) == sorted(
        MessageToDict(ref.model_stats[0]))
    same_error(servers, lambda c: c.get_inference_statistics("nope"),
               kserve=True)


def test_kserve_settings_and_shared_memory_match_jax(servers):
    from human_body_proportion_estimation_tpu_torch.utils import logging

    before = logging.log_settings()
    try:
        ref, got = both(servers, lambda c: c.get_log_settings(), kserve=True)
        assert got == ref
        ref, got = both(servers, lambda c: c.get_trace_settings(),
                        kserve=True)
        assert got == ref
        same_error(servers, lambda c: c.update_log_settings(
            {"log_format": "nope"}), kserve=True)
    finally:
        logging.configure_logging(before)
    for client in servers["kclients"]:
        assert client._channel.unary_unary(
            "/inference.GRPCInferenceService/SystemSharedMemoryStatus",
            request_serializer=(
                kpb.SystemSharedMemoryStatusRequest.SerializeToString),
            response_deserializer=(
                kpb.SystemSharedMemoryStatusResponse.FromString),
        )(kpb.SystemSharedMemoryStatusRequest()).regions == {}
    same_error(servers, lambda c: c._channel.unary_unary(
        "/inference.GRPCInferenceService/CudaSharedMemoryRegister",
        request_serializer=kpb.CudaSharedMemoryRegisterRequest
        .SerializeToString,
        response_deserializer=kpb.CudaSharedMemoryRegisterResponse.FromString,
    )(kpb.CudaSharedMemoryRegisterRequest(name="x")), kserve=True)


# --------------------------------------------------------------------- #
# the server's --grpc-port, and serve/perf


def test_server_main_exits_when_grpc_cannot_start(monkeypatch, capsys):
    """`--grpc-port N` with grpc missing: exit code 2 before any model is
    built, the import error and the hint to pass --grpc-port 0."""
    import builtins
    import sys

    from human_body_proportion_estimation_tpu_torch.serve import server

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    real_import = builtins.__import__

    def no_grpc(name, *args, **kwargs):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError("No module named 'grpc'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(server, "InferencePipeline", no_model)
    monkeypatch.setitem(sys.modules, "grpc", None)
    monkeypatch.setattr(builtins, "__import__", no_grpc)
    for argv in ([], ["--grpc-port", "9000"]):
        with pytest.raises(SystemExit) as exc:
            server.main(argv)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "No module named 'grpc'" in err
        assert "--grpc-port 0" in err


def test_perf_model_level_drives_the_port_registry(servers):
    from human_body_proportion_estimation_tpu_torch.serve import perf

    meta = servers["clients"][1].model_metadata("hrnet")
    inputs = perf._random_model_inputs(meta, 2)
    assert inputs["input"].shape == (2, 3, 64, 64)
    r = perf.run_model_level(servers["port"], "hrnet", 2, 0.5, inputs)
    assert r["transport"] == "grpc_model_infer" and r["errors"] == 0
    assert r["requests"] >= 2 and r["throughput_rps"] > 0
    assert r["latency_ms_p50"] <= r["latency_ms_p95"]
