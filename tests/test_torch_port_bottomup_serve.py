"""The port's serving edge over its bottom-up pipeline (`serve.server
--bottom-up`, ROADMAP item 13) beside the JAX package's, on the CPU.

Both `ServingApp`s run in-process on port 0 over the tiny bottom-up
pipelines of tests/test_torch_port_bottomup.py (the same weights, f32,
128x128; a tag threshold of 100 on both sides, so that every candidate
joins a group and most segments of a served person are visible, where the
default 1.0 leaves random weights with 0-2): the JAX app on its Python
batcher one image a batch, the port's on its native batcher. The same
bodies go to both: the file route, the video route, garbage bytes and
/health as tests/test_bottomup_serving.py drives the JAX one, with cm
values to 1e-3; the hbpe gRPC Estimate of the
port against its own file route; the registry's `higherhrnet` runs the
pipeline's module (the JAX registry shares a bottom-up pipeline's too);
and the server's flag matrix: `--bottom-up` with the default detector
(`ssd_mobilenet`) serves, with `--checkpoint-dir` on a machine without
tensorstore it exits 2 naming the package, with `--data-parallel 2`
(alone or beside `--artifact-dir`) it exits 2 naming the CUDA devices
it lacks (tests/conftest.py hides every GPU).
"""

import json
import threading

import numpy as np
import pytest
import torch

from human_body_proportion_estimation_tpu.serve.server import (
    ServingApp as JServingApp,
    create_server as jcreate_server,
)
from human_body_proportion_estimation_tpu.utils.config import (
    PipelineConfig as JPipelineConfig,
    ServeConfig as JServeConfig,
)
from human_body_proportion_estimation_tpu_torch.pipeline import (
    bottomup as tbottomup,
)
from human_body_proportion_estimation_tpu_torch.serve import (
    server as tserver,
)
from tests.test_torch_port_bottomup import (
    make_pipelines,
    port_tiny_model,
    sample_images,
)
from tests.test_torch_port_serve import multipart, png, request

FILE_ROUTE = "/body_proportion_length_estimation_file"
VIDEO_ROUTE = "/body_proportion_length_estimation_video"
TOL = dict(rel=1e-3, abs=1e-3)


@pytest.fixture(scope="module")
def servers():
    jpipe, tpipe, _ = make_pipelines(tag_threshold=100.0)
    japp = JServingApp(jpipe, JPipelineConfig(
        serve=JServeConfig(max_batch=1, native_batcher=False)))
    tapp = tserver.ServingApp(tpipe)
    out = []
    for app, create in ((japp, jcreate_server),
                        (tapp, tserver.create_server)):
        server = create(app, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append((server, app))
    yield {"jax": out[0][0].server_address[1],
           "port": out[1][0].server_address[1], "tapp": tapp,
           "tpipe": tpipe, "jpipe": jpipe}
    for server, app in out:
        server.shutdown()
        app.shutdown()


def both(servers, fn):
    return fn(servers["jax"]), fn(servers["port"])


def assert_same_answer(got, ref):
    """Same keys, code (where the answer has one: a video frame has
    none), msg and visible segments; cm to 1e-3."""
    assert list(got) == list(ref)
    assert (got.get("code"), got["msg"]) == (ref.get("code"), ref["msg"])
    g, r = got["body_proportion_lengths_(cm)"], ref[
        "body_proportion_lengths_(cm)"]
    assert list(g) == list(r)
    numbers = 0
    for name in r:
        if isinstance(r[name], str):
            assert g[name] == r[name], name
        else:
            assert g[name] == pytest.approx(r[name], **TOL), name
            numbers += 1
    return numbers


def test_file_route_matches_jax(servers):
    """The reference's JSON contract, answer for answer, on 3 images."""
    numbers = 0
    for img in sample_images():
        body, ctype = multipart({
            "file": (png(img), "person.png"),
            "person_height_in_cm": ("172", None),
            "threshold": ("0.7", None),
        })
        (s_ref, ref), (s_got, got) = both(
            servers, lambda p: request(p, "POST", FILE_ROUTE, body, ctype))
        assert s_got == s_ref == 200
        ref, got = json.loads(ref), json.loads(got)
        assert set(got) == {"code", "msg", "body_proportion_lengths_(cm)"}
        assert got["code"] == "success"
        numbers += assert_same_answer(got, ref)
    assert numbers >= 20


def test_health_reports_pose_weights_like_jax(servers):
    (s_ref, ref), (s_got, got) = both(
        servers, lambda p: request(p, "GET", "/health"))
    ref, got = json.loads(ref), json.loads(got)
    assert s_got == s_ref == 200
    assert got["weights"] == ref["weights"] == {"pose": "real"}
    assert set(got) == set(ref)


def test_garbage_bytes_never_500(servers):
    body, ctype = multipart({"file": (b"not an image", "x.jpg")})
    (s_ref, ref), (s_got, got) = both(
        servers, lambda p: request(p, "POST", FILE_ROUTE, body, ctype))
    assert s_got == s_ref == 200
    assert json.loads(got) == json.loads(ref)
    assert json.loads(got)["code"] == "failed"


def test_video_route_matches_jax(servers):
    """A lossless 4-frame clip: per-frame answers and the median."""
    import os
    import tempfile

    import cv2

    path = tempfile.mktemp(suffix=".avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 5.0,
                             (128, 128))
    for i in range(4):
        frame = cv2.resize(sample_images()[i % 3], (128, 128))
        writer.write(frame[..., ::-1].copy())
    writer.release()
    with open(path, "rb") as fh:
        data = fh.read()
    os.unlink(path)
    body, ctype = multipart({"file": (data, "clip.avi"),
                             "person_height_in_cm": ("180", None)})
    (s_ref, ref), (s_got, got) = both(
        servers, lambda p: request(p, "POST", VIDEO_ROUTE, body, ctype))
    ref, got = json.loads(ref), json.loads(got)
    assert s_got == s_ref == 200
    assert list(got) == list(ref)
    assert got["num_frames_processed"] == ref["num_frames_processed"] == 4
    for g, r in zip(got["frames"], ref["frames"]):
        assert g["frame"] == r["frame"]
        assert_same_answer(g, r)
    g_med = got["median_body_proportion_lengths_(cm)"]
    r_med = ref["median_body_proportion_lengths_(cm)"]
    assert list(g_med) == list(r_med)
    for name in r_med:
        if isinstance(r_med[name], str):
            assert g_med[name] == r_med[name]
        else:
            assert g_med[name] == pytest.approx(r_med[name], **TOL)


def test_grpc_estimate_serves_the_bottom_up_answer(servers):
    """hbpe `Estimate` on the port's gRPC edge gives the file route's
    answer for the same image."""
    pytest.importorskip("grpc")
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
        create_grpc_server,
    )

    server, gport = create_grpc_server(servers["tapp"], "127.0.0.1", 0)
    server.start()
    client = GrpcClient(f"127.0.0.1:{gport}")
    try:
        img = sample_images()[1]
        got = client.estimate(png(img), 165, 0.7)
        body, ctype = multipart({"file": (png(img), "p.png"),
                                 "person_height_in_cm": ("165", None)})
        ref = json.loads(request(servers["port"], "POST", FILE_ROUTE, body,
                                 ctype)[1])
        assert assert_same_answer(got, ref) >= 1
    finally:
        client.close()
        server.stop(0)


def test_registry_higherhrnet_is_the_pipelines_module(servers):
    """`higherhrnet` runs the bottom-up pipeline's own HigherHRNet (a
    forward hook on it fires) with its weights label, and answers the
    JAX registry's (built beside the JAX bottom-up pipeline) to 1e-4; the
    other models are built as with no pipeline, on both sides."""
    from human_body_proportion_estimation_tpu.serve.registry import (
        build_registry as jbuild,
    )

    tapp, tpipe, jpipe = servers["tapp"], servers["tpipe"], servers["jpipe"]
    jreg = jbuild(jpipe, include=("higherhrnet", "hrnet"))
    treg = tapp.registry
    got_idx = {r["name"]: r["weights"] for r in treg.index()}
    ref_idx = {r["name"]: r["weights"] for r in jreg.index()}
    assert got_idx["higherhrnet"] == ref_idx["higherhrnet"] == "real"
    assert got_idx["hrnet"] == ref_idx["hrnet"] == "random"
    # the SSD is registered (built at its first load, from ssd.tflite)
    assert got_idx["ssd_mobilenet"] == "real"
    calls = []
    hook = tpipe.model.register_forward_hook(lambda *a: calls.append(1))
    x = np.random.default_rng(7).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    try:
        got = treg.infer("higherhrnet", {"input": x})
    finally:
        hook.remove()
    assert calls == [1]
    with torch.inference_mode():
        own = tpipe.model(torch.from_numpy(x))
    ref = jreg.infer("higherhrnet", {"input": x})
    for name in ("output_1", "output_2"):
        np.testing.assert_array_equal(got[name], own[name].numpy())
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4,
                                   atol=1e-4)
    jreg.shutdown()


@pytest.mark.parametrize("certified", [False, True])
def test_bottom_up_serves_with_the_default_detector(certified, monkeypatch,
                                                    capsys):
    """`--bottom-up` with the default `--detector ssd_mobilenet` builds the
    bottom-up pipeline (forced onto the CPU and the tiny model here) and
    serves it, announced as the JAX server announces it: random weights
    with the WARNING line, or the certified bottom-up checkpoint, labelled
    "synthetic-certified", when the repository holds it."""
    from human_body_proportion_estimation_tpu_torch.models import (
        weights as tw,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
    )

    plain = tbottomup.BottomUpPipeline
    monkeypatch.setattr(tbottomup, "BottomUpPipeline", lambda **kw: plain(
        **{**kw, "device": "cpu", "dtype": torch.float32,
           "model": port_tiny_model()}))
    if certified:
        state = flax_to_state_dict(make_pipelines(seed=50)[2])
        monkeypatch.setattr(tbottomup, "maybe_load_certified",
                            lambda bottom_up=False: (None, state))
    served = []
    monkeypatch.setattr(tserver, "_serve",
                        lambda args, pipe: served.append((args, pipe)))
    tserver.main(["--bottom-up", "--grpc-port", "0"])
    ((args, pipe),) = served
    assert args.detector == "ssd_mobilenet"
    assert isinstance(pipe, plain)
    out = capsys.readouterr().out
    if certified:
        assert pipe.weights_origin == {"pose": "synthetic-certified"}
        assert out.startswith("serving committed synthetic-certified "
                              "bottom-up weights (")
        assert tw.default_certified_bottomup_checkpoint() in out
    else:
        assert pipe.weights_origin == {"pose": "random"}
        assert ("WARNING: serving RANDOM-INIT HigherHRNet — outputs are "
                "garbage; pass --checkpoint-dir (see /health 'weights')"
                in out)


@pytest.mark.parametrize("extra,item", [
    (["--checkpoint-dir", "x"], "needs the tensorstore package"),
    (["--data-parallel", "2"], "--data-parallel 2: 2 devices asked for"),
    (["--artifact-dir", "x", "--data-parallel", "2"],
     "--data-parallel 2: 2 devices asked for"),
])
def test_bottom_up_exits_on_options_not_ported(extra, item, monkeypatch,
                                               capsys):
    def no_model(*a, **k):
        raise AssertionError("a model was built")

    from human_body_proportion_estimation_tpu_torch.cli import common

    monkeypatch.setattr(tbottomup, "BottomUpPipeline", no_model)
    # a machine without tensorstore (--checkpoint-dir reads through it)
    monkeypatch.setattr(common, "has_tensorstore", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tserver.main(["--bottom-up", *extra])
    assert exc.value.code == 2
    # this machine has fewer than the two CUDA devices --data-parallel 2
    # asks for
    assert item in capsys.readouterr().err
