"""The port's model registry and its KServe-v2 HTTP routes against the JAX
package's, on the CPU.

Both registries serve the same tiny weights (tests/torch_port_tiny.py,
float32 on both sides): the JAX one through its own `build_registry` over
the canonical f32 EfficientDet, the port's built by its `ServingApp` from
the port pipeline, whose HRNet and EfficientDet it shares. Documents must
be equal but for `platform`; tensors agree to 1e-3 (two f32 convolution
implementations; detection scores and boxes agree to ~1e-5 here), keep
masks and classes exactly.

Known divergence (ROADMAP.md section 3): the JAX registry runs its
detector models under `jax.jit`, whose fused crop returns a zero last row
or column for a box reaching the far image edge, while the port's crop, as
the JAX op run eagerly, samples the edge pixel there. Crops and heatmaps
of such slots are compared off that row and column, and the row itself
against the eager JAX op.
"""

import dataclasses
import http.client
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_body_proportion_estimation_tpu.ops import crop as jcrop
from human_body_proportion_estimation_tpu.serve.server import (
    ServingApp as JServingApp,
    create_server as jcreate_server,
)
from human_body_proportion_estimation_tpu_torch.serve import (
    registry as tregistry,
)
from human_body_proportion_estimation_tpu_torch.serve.server import (
    ServingApp as TServingApp,
    create_server as tcreate_server,
)
from tests.torch_port_tiny import (
    MAX_BATCH,
    NOT_PORTED,
    PORTED,
    image,
    jax_pipeline,
    jax_registry,
    modified_inputs,
    tiny_models,
)

TOL = dict(rtol=1e-3, atol=1e-3)
PLATFORM = {"hrnet": "pytorch", "edetlite4": "pytorch",
            "edetlite4_modified": "pytorch",
            "ensemble_edet4_person_det_pose": "pytorch_ensemble"}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def apps(models):
    """The JAX and port `ServingApp`s (Python batchers), each on an HTTP
    server on port 0, and their registries."""
    jserve = dataclasses.replace(models.jcfg.serve, native_batcher=False)
    tserve = dataclasses.replace(models.tcfg.serve, native_batcher=False)
    japp = JServingApp(jax_pipeline(models),
                       dataclasses.replace(models.jcfg, serve=jserve))
    japp._registry = jax_registry(models)
    tapp = TServingApp(models.tpipe,
                       dataclasses.replace(models.tcfg, serve=tserve))
    out = {"jreg": japp._registry, "treg": tapp.registry, "tapp": tapp}
    servers = []
    for key, app, create in (("jax", japp, jcreate_server),
                             ("port", tapp, tcreate_server)):
        server = create(app, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append((server, app))
        out[key] = server.server_address[1]
    yield out
    for server, app in servers:
        server.shutdown()
        app.shutdown()


def both(apps, fn):
    return fn(apps["jreg"]), fn(apps["treg"])


def close(got, ref, what=""):
    np.testing.assert_allclose(got, np.asarray(ref), err_msg=what, **TOL)


# --------------------------------------------------------------------- #
# documents


def test_index_lists_the_four_ported_models(apps):
    ref, got = both(apps, lambda r: r.index())
    assert [row["name"] for row in got] == sorted(PORTED)
    for g, r in zip(got, ref):
        assert {k: g[k] for k in ("name", "version", "state", "weights")} == {
            k: r[k] for k in ("name", "version", "state", "weights")}
    assert all(row["weights"] == "real" for row in got)


@pytest.mark.parametrize("name", PORTED)
def test_documents_equal_the_jax_ones(apps, name):
    """metadata and config: the JAX documents, `platform` apart."""
    for doc in ("metadata", "config"):
        ref, got = both(apps, lambda r: getattr(r, doc)(name))
        assert got.pop("platform") == PLATFORM[name]
        assert ref.pop("platform").startswith("jax_xla")
        assert got == ref, doc
    meta = apps["treg"].metadata(name)
    if name == "hrnet":
        assert meta["max_batch_size"] == MAX_BATCH
        assert meta["inputs"][0]["shape"] == [-1, 3, 64, 64]
        assert meta["outputs"][0]["shape"] == [-1, 17, 16, 16]


@pytest.mark.parametrize("name", NOT_PORTED)
def test_models_not_ported_answer_as_unknown_names(apps, name):
    treg = apps["treg"]
    for call in (lambda: treg.metadata(name), lambda: treg.config(name),
                 lambda: treg.statistics(name), lambda: treg.load(name),
                 lambda: treg.unload(name),
                 lambda: treg.infer(name, {"image": image(0)})):
        with pytest.raises(KeyError) as exc:
            call()
        assert f"model '{name}' not found; repository has " in str(exc.value)


def test_version_surface_matches_jax(apps):
    x = np.zeros((1, 3, 64, 64), np.float32)
    for call in (lambda r: r.metadata("hrnet", "2"),
                 lambda r: r.config("hrnet", "0"),
                 lambda r: r.statistics("hrnet", "9"),
                 lambda r: r.infer("hrnet", {"input": x}, version="2")):
        msgs = []
        for reg in (apps["jreg"], apps["treg"]):
            with pytest.raises(KeyError, match="no version") as exc:
                call(reg)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    ref, got = both(apps, lambda r: r.metadata("hrnet", "1"))
    assert got["versions"] == ref["versions"] == ["1"]


_BAD = {
    "unknown_input": ("hrnet", {"wrong": np.zeros((1, 3, 64, 64), np.float32)},
                      None),
    "missing_input": ("hrnet", {}, None),
    "dtype": ("hrnet", {"input": np.zeros((1, 3, 64, 64), np.float64)}, None),
    "rank": ("hrnet", {"input": np.zeros((3, 64, 64), np.float32)}, None),
    "shape": ("hrnet", {"input": np.zeros((1, 3, 32, 64), np.float32)}, None),
    "batch": ("hrnet", {"input": np.zeros((8, 3, 64, 64), np.float32)}, None),
    "output": ("hrnet", {"input": np.zeros((1, 3, 64, 64), np.float32)},
               ["nope"]),
    "modified_thres_shape": (
        "edetlite4_modified",
        {**modified_inputs(image(0), 0.5),
         "det_thres": np.zeros((2,), np.float32)}, None),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_validation_errors_match_jax(apps, case):
    name, inputs, outputs = _BAD[case]
    msgs = []
    for reg in (apps["jreg"], apps["treg"]):
        with pytest.raises(ValueError) as exc:
            reg.infer(name, inputs, outputs)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_requested_outputs_filter_matches_jax(apps):
    inputs = modified_inputs(image(12), 0.5)
    names = ["filtered_boxes", "detection_scores"]
    ref, got = both(apps, lambda r: r.infer("edetlite4_modified", inputs,
                                            names))
    assert list(got) == list(ref) == names
    for k in names:
        close(got[k], ref[k], k)


# --------------------------------------------------------------------- #
# tensors


def test_hrnet_matches_jax_and_a_direct_forward(apps, models):
    x = np.random.default_rng(0).random((3, 3, 64, 64), np.float32)
    ref, got = both(apps, lambda r: r.infer("hrnet", {"input": x}))
    assert got["output"].shape == (3, 17, 16, 16)
    close(got["output"], ref["output"])
    with torch.inference_mode():
        direct = models.tpipe.pose(torch.from_numpy(
            np.concatenate([x, np.zeros_like(x[:1])]))).numpy()[:3]
    np.testing.assert_array_equal(got["output"], direct)


@pytest.mark.parametrize("hw", [(128, 128), (150, 200)],
                         ids=["detector_size", "resized"])
def test_edetlite4_raw_matches_jax(apps, hw):
    img = image(12, hw)
    ref, got = both(apps, lambda r: r.infer("edetlite4", {"image": img}))
    assert {k: v.shape for k, v in got.items()} == {
        "output_0": (1, 100, 4), "output_1": (1, 100), "output_2": (1, 100)}
    scores = got["output_1"][0]
    assert (scores > 0).sum() >= 10
    assert (np.diff(scores) <= 0).all()                  # non-increasing
    assert set(np.unique(got["output_2"][0][scores > 0])) <= set(
        range(1, 91))                                    # 1-based classes
    assert (got["output_2"][0][scores == 0] == 0).all()
    np.testing.assert_array_equal(got["output_2"], ref["output_2"])
    close(got["output_1"], ref["output_1"])
    close(got["output_0"], ref["output_0"])
    assert got["output_0"][..., 2].max() <= hw[0] + 1e-3   # wire pixels
    assert got["output_0"][..., 3].max() <= hw[1] + 1e-3


def _far_edge(boxes):
    return np.any(boxes[:, 2:] >= 1.0 - 1e-6, -1)


def _eager_crop(boxes, img):
    """The JAX crop op run eagerly (TF semantics) on the port's boxes."""
    crops = np.asarray(jcrop.crop_and_resize(
        jnp.asarray(img[0].astype(np.float32) / 255.0), jnp.asarray(boxes),
        64, 64))
    return crops.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("thres", [0.5, 1.5], ids=["persons", "no_person"])
def test_modified_matches_jax(apps, thres):
    img = image(12)
    inputs = modified_inputs(img, thres)
    ref, got = both(apps, lambda r: r.infer("edetlite4_modified", inputs))
    for k in ("detection_boxes", "detection_scores", "detection_classes",
              "filtered_boxes"):
        assert got[k].shape == ref[k].shape, k
        close(got[k], ref[k], k)
    n = got["filtered_boxes"].shape[0]
    crops, ref_crops = got["human_crops"], ref["human_crops"]
    assert crops.shape == ref_crops.shape == (max(n, 1), 3, 64, 64)
    if n == 0:
        assert thres == 1.5
        assert not crops.any() and not ref_crops.any()
        return
    assert thres == 0.5 and n == 3
    fb = got["filtered_boxes"]
    assert (fb >= 0).all() and (fb <= 1).all()
    edge = _far_edge(fb)
    close(crops[~edge], ref_crops[~edge], "crops off the far edge")
    close(crops[edge][..., :-1, :-1], ref_crops[edge][..., :-1, :-1],
          "far-edge crops but their last row and column")
    np.testing.assert_allclose(crops, _eager_crop(fb, img), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("thres", [0.5, 1.5], ids=["persons", "no_person"])
def test_ensemble_matches_jax(apps, thres):
    img = image(12)
    inputs = modified_inputs(img, thres)
    name = "ensemble_edet4_person_det_pose"
    ref, got = both(apps, lambda r: r.infer(name, inputs))
    boxes = got["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"]
    hm = got["ENSEMBLE_OUTPUT_HEATMAPS"]
    n = boxes.shape[0]
    assert hm.shape == ref["ENSEMBLE_OUTPUT_HEATMAPS"].shape == (
        max(n, 1), 17, 16, 16)
    close(boxes, ref["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"])
    off = ~_far_edge(boxes) if n else np.ones(1, bool)
    assert off.any()
    close(hm[off], ref["ENSEMBLE_OUTPUT_HEATMAPS"][off])
    # the ensemble is modified's boxes then the pose model on its crops
    mod = apps["treg"].infer("edetlite4_modified", inputs)
    np.testing.assert_array_equal(boxes, mod["filtered_boxes"])
    with torch.inference_mode():
        direct = apps["tapp"].pipeline.pose(
            torch.from_numpy(mod["human_crops"])).numpy()
    np.testing.assert_allclose(hm, direct, rtol=1e-5, atol=1e-5)


def test_crop_far_edge_rows_follow_the_eager_op(apps):
    """The documented divergence on the registry: a person box that
    reaches the far edge, whose last crop row the jit-fused JAX crop zeroes
    and the port samples as the eager op does."""
    img = image(12)
    # an x expansion of half the width takes boxes to the right edge
    inputs = modified_inputs(img, 0.5, x_change=64.0)
    ref, got = both(apps, lambda r: r.infer("edetlite4_modified", inputs))
    edge = _far_edge(got["filtered_boxes"])
    assert edge.any() and not edge.all()
    crops = got["human_crops"][edge]
    assert np.abs(crops[..., -1, :]).sum() > 0
    assert np.abs(crops[..., :, -1]).sum() > 0
    np.testing.assert_allclose(
        crops, _eager_crop(got["filtered_boxes"][edge], img),
        rtol=1e-4, atol=1e-4)
    close(got["human_crops"][~edge], ref["human_crops"][~edge])
    jrows = ref["human_crops"][edge]
    close(crops[..., :-1, :-1], jrows[..., :-1, :-1])
    if np.abs(jrows[..., :, -1]).sum() == 0:    # the divergence, while it lasts
        assert np.abs(crops[..., :, -1] - jrows[..., :, -1]).max() > 0.1
    else:
        close(crops, jrows)


# --------------------------------------------------------------------- #
# batching, load / unload, statistics


def test_hrnet_coalesces_under_the_row_cap(apps, models):
    """Concurrent 1-3 row requests coalesce into fewer launches, none over
    max_batch_size rows, each answer equal to a direct forward of its
    rows padded alone to their bucket."""
    from concurrent.futures import ThreadPoolExecutor

    entry = apps["treg"]._models["hrnet"]
    entry.shutdown()
    entry.batch_timeout_ms = 100.0
    rng = np.random.default_rng(3)
    xs = [rng.random((1 + i % 3, 3, 64, 64), np.float32) for i in range(8)]
    before = entry.batches_run
    stats0 = {b: c[0] for b, c in entry.batch_stats.items()}
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(
            lambda x: apps["treg"].infer("hrnet", {"input": x}), xs))
    launches = entry.batches_run - before
    assert launches < len(xs), launches
    new = {b: c[0] - stats0.get(b, 0) for b, c in entry.batch_stats.items()}
    assert max(b for b, c in new.items() if c) <= MAX_BATCH
    assert sum(b * c for b, c in new.items()) == sum(len(x) for x in xs)
    with torch.inference_mode():
        for x, out in zip(xs, outs):
            direct = models.tpipe.pose(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(out["output"], direct, rtol=1e-5,
                                       atol=1e-5)
    entry.shutdown()
    entry.batch_timeout_ms = models.tcfg.serve.batch_timeout_ms


def test_run_coalesced_respects_row_cap_and_shape_groups():
    launches = []

    def build():
        def run(inputs):
            launches.append(inputs["x"].shape)
            return {"y": inputs["x"] * 2.0}

        return run

    e = tregistry.ModelEntry(
        name="m", platform="test",
        inputs=[tregistry.TensorSpec("x", "FP32", (-1, -1))],
        outputs=[tregistry.TensorSpec("y", "FP32", (-1, -1))],
        max_batch_size=4, weights="random", build=build,
    )
    payloads = [
        {"x": np.full((2, 4), 0, np.float32)},
        {"x": np.full((2, 4), 1, np.float32)},
        {"x": np.full((1, 4), 2, np.float32)},   # 2+2+1 > 4 -> two launches
        {"x": np.full((2, 8), 3, np.float32)},   # other dims -> own group
    ]
    results = e._run_coalesced(payloads)
    assert sorted(launches) == [(1, 4), (2, 8), (4, 4)]
    for p, r in zip(payloads, results):
        np.testing.assert_array_equal(r["y"], p["x"] * 2.0)
    assert {b: c[0] for b, c in e.batch_stats.items()} == {1: 1, 2: 1, 4: 1}


def test_shared_core_is_released_only_when_no_sibling_is_loaded(
        apps, monkeypatch):
    """The three detector models share one core over the pipeline's
    EfficientDet: it is rebuilt only after all three were unloaded, and
    loading builds no module of its own."""
    from human_body_proportion_estimation_tpu_torch.models import (
        efficientdet as tedet,
        hrnet as thrnet,
    )

    treg = apps["treg"]
    builds = []
    real = tregistry._build_edet_core
    monkeypatch.setattr(tregistry, "_build_edet_core",
                        lambda *a, **k: builds.append(1) or real(*a, **k))

    def no_module(*a, **k):
        raise AssertionError("the registry built a model of its own")

    monkeypatch.setattr(tedet.EfficientDet, "__init__", no_module)
    monkeypatch.setattr(thrnet.HRNet, "__init__", no_module)
    names = ("edetlite4", "edetlite4_modified",
             "ensemble_edet4_person_det_pose")
    for name in names:
        treg.unload(name)
    for name in names:
        treg.load(name)
    assert len(builds) == 1
    treg.unload("edetlite4")
    treg.unload("edetlite4_modified")
    treg.load("edetlite4")                     # the ensemble holds the core
    assert len(builds) == 1
    for name in names:
        treg.unload(name)
    treg.load("edetlite4_modified")
    assert len(builds) == 2
    loaded = {r["name"]: r["loaded"] for r in treg.index()}
    assert loaded["edetlite4_modified"] and not loaded["edetlite4"]


def test_unload_dependents_matches_jax(apps):
    for reg in (apps["jreg"], apps["treg"]):
        for name in PORTED:
            reg.load(name)
        reg.unload("ensemble_edet4_person_det_pose", unload_dependents=True)
    ref, got = both(apps, lambda r: {row["name"]: row["loaded"]
                                     for row in r.index()})
    assert got == ref == {"edetlite4": True, "edetlite4_modified": False,
                          "ensemble_edet4_person_det_pose": False,
                          "hrnet": False}


def test_statistics_follow_triton_semantics(apps):
    treg = apps["treg"]
    x = np.zeros((2, 3, 64, 64), np.float32)
    (row0,) = treg.statistics("hrnet")["model_stats"]
    treg.infer("hrnet", {"input": x})
    with pytest.raises(ValueError):
        treg.infer("hrnet", {"bogus": x})
    (row,) = treg.statistics("hrnet")["model_stats"]
    assert row["inference_count"] - row0["inference_count"] == 2
    assert row["execution_count"] - row0["execution_count"] == 1
    s, s0 = row["inference_stats"], row0["inference_stats"]
    assert s["fail"]["count"] - s0["fail"]["count"] == 1
    assert s["success"]["ns"] >= s["queue"]["ns"]
    ref, got = both(apps, lambda r: r.statistics())
    assert [m["name"] for m in got["model_stats"]] == sorted(PORTED)

    def keys(doc):
        m = doc["model_stats"][0]
        return sorted(m), sorted(m["inference_stats"])

    assert keys(got) == keys(ref)
    assert treg.stats()["hrnet"]["batches_run"] == row["execution_count"]


def test_certified_fallback_labels_unshared_slots(monkeypatch, tmp_path):
    """Without a pipeline the slots take the committed certified weights,
    lazily (metadata flips, nothing loads), unless the environment turns
    the fallback off; the switch and the labels are the JAX package's."""
    from human_body_proportion_estimation_tpu_torch.models import weights

    monkeypatch.delenv("HBPE_DISABLE_CERTIFIED_FALLBACK", raising=False)
    reg = tregistry.build_registry(device="cpu")
    idx = {r["name"]: r for r in reg.index()}
    assert set(idx) == set(PORTED)
    for name in PORTED:
        assert idx[name]["weights"] == "synthetic-certified", name
        assert not idx[name]["loaded"]
    monkeypatch.setattr(weights, "default_certified_checkpoint",
                        lambda: str(tmp_path / "missing.npz"))
    reg = tregistry.build_registry(device="cpu")
    assert {r["weights"] for r in reg.index()} == {"random"}
    monkeypatch.undo()                   # the tests' setting: switched off
    reg = tregistry.build_registry(device="cpu")
    assert {r["weights"] for r in reg.index()} == {"random"}


# --------------------------------------------------------------------- #
# the /v2 HTTP routes, JAX and port servers side by side


def request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), data


def routes(apps, method, path, body=None, headers=None):
    return [request(apps[k], method, path, body, headers)
            for k in ("jax", "port")]


def _normalize(doc):
    """A JSON document with the runtime's name and the load state (which
    depends on what ran before) taken out."""
    if isinstance(doc, dict):
        return {k: ("*" if k in ("platform", "loaded") else _normalize(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_normalize(v) for v in doc]
    return doc


@pytest.mark.parametrize("path", [
    "/v2/models", "/v2/models/hrnet", "/v2/models/hrnet/versions/1",
    "/v2/models/hrnet/config", "/v2/models/edetlite4/config",
    "/v2/models/ensemble_edet4_person_det_pose",
    "/v2/models/edetlite4_modified/versions/1/ready",
    "/v2/models/hrnet/versions/2", "/v2/models/yolov5m",
    "/v2/models/hrnet/bogus",
])
def test_v2_get_routes_match_jax(apps, path):
    (s_ref, _, ref), (s_got, _, got) = routes(apps, "GET", path)
    assert s_got == s_ref
    ref, got = json.loads(ref), json.loads(got)
    assert _normalize(got) == _normalize(ref)


def test_v2_stats_routes_match_jax(apps):
    for path in ("/v2/models/stats", "/v2/models/hrnet/stats",
                 "/v2/models/nope/stats"):
        (s_ref, _, ref), (s_got, _, got) = routes(apps, "GET", path)
        assert s_got == s_ref
        ref, got = json.loads(ref), json.loads(got)
        if s_got != 200:
            assert got == ref
            continue
        assert [m["name"] for m in got["model_stats"]] == [
            m["name"] for m in ref["model_stats"]]
        assert sorted(got["model_stats"][0]) == sorted(ref["model_stats"][0])


def _infer_body(inputs, binary, outputs=None, classification=None):
    """A /v2 infer request: JSON tensors or the binary_tensor_data
    transport."""
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        NP_TO_TRITON,
    )

    tensors, chunks = [], []
    for name, v in inputs.items():
        t = {"name": name, "shape": list(v.shape),
             "datatype": NP_TO_TRITON[v.dtype]}
        if binary:
            chunks.append(v.tobytes())
            t["parameters"] = {"binary_data_size": len(chunks[-1])}
        else:
            t["data"] = v.ravel().tolist()
        tensors.append(t)
    doc = {"inputs": tensors}
    if binary:
        doc["parameters"] = {"binary_data_output": True}
    if outputs:
        doc["outputs"] = [
            {"name": o, **({"parameters": {"classification": classification}}
                           if classification else {})} for o in outputs]
    header = json.dumps(doc).encode()
    if not binary:
        return header, {"Content-Type": "application/json"}
    return header + b"".join(chunks), {
        "Content-Type": "application/octet-stream",
        "Inference-Header-Content-Length": str(len(header))}


def _infer_reply(status, headers, data):
    """(reply JSON, {name: array}) of an infer answer."""
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        TRITON_TO_NP,
    )
    from human_body_proportion_estimation_tpu_torch.serve.wire import (
        deserialize_bytes_tensor,
    )

    hlen = {k.lower(): v for k, v in headers.items()}.get(
        "inference-header-content-length")
    if hlen is None:
        reply, blob = json.loads(data), b""
    else:
        reply, blob = json.loads(data[:int(hlen)]), data[int(hlen):]
    if status != 200:
        return reply, None
    out, cursor = {}, 0
    for t in reply["outputs"]:
        nbin = (t.get("parameters") or {}).get("binary_data_size")
        if t["datatype"] == "BYTES":
            rows = (deserialize_bytes_tensor(blob[cursor:cursor + nbin])
                    if nbin is not None else [x.encode() for x in t["data"]])
            out[t["name"]] = np.asarray(rows, object).reshape(t["shape"])
        elif nbin is not None:
            out[t["name"]] = np.frombuffer(
                blob[cursor:cursor + nbin],
                TRITON_TO_NP[t["datatype"]]).reshape(t["shape"])
        else:
            out[t["name"]] = np.asarray(
                t["data"], TRITON_TO_NP[t["datatype"]]).reshape(t["shape"])
        cursor += nbin or 0
    return reply, out


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_v2_infer_matches_jax(apps, binary):
    x = np.random.default_rng(5).random((2, 3, 64, 64), np.float32)
    body, headers = _infer_body({"input": x}, binary)
    (ref, r_out), (got, g_out) = [
        _infer_reply(*r) for r in routes(apps, "POST",
                                         "/v2/models/hrnet/infer", body,
                                         headers)]
    for doc in (got, ref):
        for t in doc["outputs"]:
            t.pop("data", None)
    assert got == ref
    assert [t["name"] for t in got["outputs"]] == ["output"]
    assert got["model_version"] == "1" and got["model_name"] == "hrnet"
    close(g_out["output"], r_out["output"])
    direct = apps["treg"].infer("hrnet", {"input": x})["output"]
    np.testing.assert_array_equal(g_out["output"], direct)


def test_v2_infer_ensemble_binary_matches_jax(apps):
    inputs = modified_inputs(image(12), 0.5)
    path = "/v2/models/ensemble_edet4_person_det_pose/versions/1/infer"
    body, headers = _infer_body(inputs, True)
    (ref, r_out), (got, g_out) = [
        _infer_reply(*r) for r in routes(apps, "POST", path, body, headers)]
    assert [t["name"] for t in got["outputs"]] == [
        t["name"] for t in ref["outputs"]]
    boxes = g_out["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"]
    close(boxes, r_out["ENSEMBLE_OUTPUT_FILTER_DET_BOXES"])
    off = ~_far_edge(boxes)
    close(g_out["ENSEMBLE_OUTPUT_HEATMAPS"][off],
          r_out["ENSEMBLE_OUTPUT_HEATMAPS"][off])


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
def test_v2_infer_classification_matches_jax(apps, binary):
    img = image(12)
    body, headers = _infer_body({"image": img}, binary, ["output_1"], 3)
    (ref, r_out), (got, g_out) = [
        _infer_reply(*r) for r in routes(apps, "POST",
                                         "/v2/models/edetlite4/infer", body,
                                         headers)]
    assert got["outputs"][0]["datatype"] == "BYTES"
    rows_ref, rows_got = r_out["output_1"], g_out["output_1"]
    assert rows_got.shape == rows_ref.shape == (1, 3)
    for g, r in zip(rows_got.ravel(), rows_ref.ravel()):
        gv, gi = g.decode().split(":")
        rv, ri = r.decode().split(":")
        assert gi == ri and float(gv) == pytest.approx(float(rv), abs=1e-5)


@pytest.mark.parametrize("case", [
    "unknown_model", "not_ported", "bad_dtype", "malformed_json",
    "truncated_binary", "trailing_bytes", "bad_header_length", "bad_route",
])
def test_v2_infer_errors_match_jax(apps, case):
    x = np.zeros((1, 3, 64, 64), np.float32)
    path = "/v2/models/hrnet/infer"
    body, headers = _infer_body({"input": x}, True)
    if case == "unknown_model":
        path = "/v2/models/nope/infer"
    elif case == "not_ported":
        path = "/v2/models/higherhrnet/infer"
    elif case == "bad_dtype":
        body, headers = _infer_body({"input": x.astype(np.float64)}, False)
    elif case == "malformed_json":
        body, headers = b"{nope", {"Content-Type": "application/json"}
    elif case == "truncated_binary":
        body = body[:-8]
    elif case == "trailing_bytes":
        body = body + b"\0" * 4
    elif case == "bad_header_length":
        headers = {**headers, "Inference-Header-Content-Length": "999999999"}
    else:
        path = "/v2/models/hrnet/versions/1/predict"
    (s_ref, _, ref), (s_got, _, got) = routes(apps, "POST", path, body,
                                              headers)
    assert s_got == s_ref and s_got in (400, 404)
    assert json.loads(got) == json.loads(ref)


def test_v2_repository_routes_match_jax(apps):
    json_h = {"Content-Type": "application/json"}
    for path, body in [
        ("/v2/repository/index", b"{}"),
        ("/v2/repository/index", b'{"ready": true}'),
        ("/v2/repository/models/hrnet/load", b""),
        ("/v2/repository/models/ensemble_edet4_person_det_pose/unload",
         b'{"parameters": {"unload_dependents": true}}'),
        ("/v2/repository/models/yolov5m/load", b"{}"),
        ("/v2/repository/models/hrnet/reload", b"{}"),
        ("/v2/repository/index", b"[1]"),
    ]:
        (s_ref, _, ref), (s_got, _, got) = routes(apps, "POST", path, body,
                                                  json_h)
        assert s_got == s_ref, path
        assert json.loads(got) == json.loads(ref), path
    ref, got = both(apps, lambda r: {row["name"]: row["loaded"]
                                     for row in r.index()})
    assert got == ref and not got["hrnet"]


def test_metrics_list_the_models_once_the_registry_is_built(apps):
    status, _, data = request(apps["port"], "GET", "/metrics")
    models = json.loads(data)["models"]
    assert status == 200 and sorted(models) == sorted(PORTED)
    assert set(models["hrnet"]) == {"loaded", "batches_run"}
