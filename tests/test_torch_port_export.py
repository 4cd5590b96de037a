"""The port's deployable artifact (`pipeline/export.py`,
`cli/export_artifact.py`, `serve.server --artifact-dir`) on the CPU, the
counterpart of the JAX package's tests/test_export_artifact.py.

The tiny models of tests/torch_port_tiny.py (128x128 detector input, 64x64
crops, f32, max batch 4) are exported once a module at batch 4 and
restored with `ArtifactPipeline(device="cpu")`: the restored rows must
equal the live port pipeline's exactly (the same f32 graph on the same
inputs at the same batch size), and the JAX package's live score-kernel
pipeline on the same weights under tests/test_torch_port_pipeline.py's
rule. The registered `hbpe` ops are held to their plain versions; the
YOLO and bottom-up artifacts are in tests/test_torch_port_export_slots.py.
"""

import dataclasses
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from human_body_proportion_estimation_tpu_torch.models.tflite_import import (
    DEFAULT_TFLITE_PATH,
)
from human_body_proportion_estimation_tpu_torch.ops import build, kernels
from human_body_proportion_estimation_tpu_torch.pipeline.export import (
    FORMAT_VERSION,
    ArtifactPipeline,
    ServingArtifact,
    export_serving_artifact,
)
from tests import torch_port_tiny as tiny
from tests.test_torch_port_pipeline import _decisive, _images

BATCH = tiny.MAX_BATCH
HEIGHTS = [[170.0], [180.0, 160.0], [175.0]]
JAX_META_KEYS = {"format_version", "batch_size", "max_persons",
                 "detector_input_hw", "pose_crop_hw", "packed_layout",
                 "config", "weights_origin"}


@pytest.fixture(scope="module")
def models():
    return tiny.tiny_models()


@pytest.fixture(scope="module")
def artifact_dir(models, tmp_path_factory):
    return export_serving_artifact(
        models.tpipe, str(tmp_path_factory.mktemp("artifact") / "repo"),
        batch_size=BATCH)


@pytest.fixture(scope="module")
def restored(artifact_dir):
    return ArtifactPipeline(artifact_dir, device="cpu")


def _program_ops(directory):
    """The hbpe ops the saved program's graph calls, in order."""
    ep = torch.export.load(os.path.join(directory, "pipeline.pt2"))
    return [str(n.target) for n in ep.graph.nodes
            if str(n.target).startswith("hbpe.")]


def test_export_restore_run_matches_live(models, artifact_dir, restored):
    assert sorted(os.listdir(artifact_dir)) == ["meta.json", "pipeline.pt2"]
    with open(os.path.join(artifact_dir, "meta.json")) as fh:
        meta = json.load(fh)
    assert JAX_META_KEYS <= set(meta)
    assert meta["format_version"] == FORMAT_VERSION
    assert meta["program"] == "pipeline.pt2" and meta["device"] == "cpu"
    assert meta["batch_size"] == BATCH and meta["max_persons"] == 3
    assert meta["detector_input_hw"] == list(tiny.DET_HW)
    assert meta["pose_crop_hw"] == list(tiny.CROP_HW)
    assert meta["weights_origin"] == {"detector": "real", "pose": "real"}
    assert restored.artifact.batch_size == BATCH
    assert restored.config == models.tcfg
    assert _program_ops(artifact_dir) == [
        "hbpe.head_score_levels.default", "hbpe.nms_sweep.default",
        "hbpe.decode_heatmaps.default"]

    live = models.tpipe.infer_serving(_images(), HEIGHTS, 0.5)
    got = restored.infer_serving(_images(), HEIGHTS, 0.5)
    assert got.shape == live.shape == (3, 3, 23)
    assert got[..., 0].sum() >= 3, "the raised person bias must yield persons"
    np.testing.assert_array_equal(got, live)


def test_artifact_matches_the_jax_forward_serving(models, restored):
    """The restored program against the JAX package's live score-kernel
    pipeline on the same weights, under tests/test_torch_port_pipeline.py's
    rule: validity exact, segments whose keypoints' argmax is decisive
    (and whose crop stays off the far edges): visibility exact, cm to
    1e-3."""
    jpipe = tiny.jax_pipeline(models)
    ref_img = jpipe.infer_images(_images(), HEIGHTS, det_threshold=0.5,
                                 with_heatmaps=True)
    _, seg_ok = _decisive(ref_img)
    ref = np.asarray(jpipe.infer_serving(_images(), HEIGHTS, 0.5))
    got = restored.infer_serving(_images(), HEIGHTS, 0.5)
    assert got.shape == ref.shape == (3, 3, 23)
    assert seg_ok.sum() >= 3
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 12:][seg_ok], ref[..., 12:][seg_ok])
    np.testing.assert_allclose(got[..., 1:12][seg_ok], ref[..., 1:12][seg_ok],
                               rtol=1e-3, atol=1e-3)


def test_artifact_pipeline_chunks_oversize_batches(models, restored):
    """6 images through a batch-4 artifact: chunks of 4 and 2, each row
    equal to the live pipeline's, identical rows for identical inputs in
    either chunk, and per-request forms cut along the chunks."""
    imgs = _images() * 2
    out = restored.infer_serving(imgs, 175.0, 0.5)
    assert out.shape == (6, 3, 23)
    live = np.concatenate([models.tpipe.infer_serving(imgs[:4], 175.0, 0.5),
                           models.tpipe.infer_serving(imgs[4:], 175.0, 0.5)])
    np.testing.assert_allclose(out, live, rtol=0, atol=1e-6)
    for i in range(3):
        np.testing.assert_array_equal(out[i], out[i + 3])
    heights = [[150.0], [175.0], [160.0]] * 2
    out2 = restored.infer_serving(imgs, heights, [0.5] * 6)
    for i in range(3):
        np.testing.assert_array_equal(out2[i], out2[i + 3])
    assert not np.array_equal(out2[0], out2[1]) or not out2[0, :, 0].any()


def test_serving_app_on_artifact(restored):
    """The HTTP edge serves from a restored artifact: the
    --artifact-dir path; the artifact's stages are host_prepare and
    device_compute_readback (the live forward's ranges are not in an
    exported graph)."""
    import cv2

    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    app = ServingApp(restored)
    try:
        ok, enc = cv2.imencode(".png", _images()[1][..., ::-1])
        assert ok

        class _Part:
            def __init__(self, data):
                self.data = data
                self.filename = None

        resp = app.handle_estimation({
            "file": _Part(enc.tobytes()),
            "person_height_in_cm": _Part(b"175"),
            "threshold": _Part(b"0.5"),
        })
        assert resp["code"] == "success"
        assert "body_proportion_lengths_(cm)" in resp
        want = restored.infer_serving([_images()[1]], 175.0, 0.5)
        assert bool(want[0, 0, 0]) == bool(resp["body_proportion_lengths_(cm)"])
        # the artifact's two stages, the edge's decode and the batcher's
        # own (the native batcher also times a formed batch's slot wait)
        assert set(app.stages.snapshot()) == {
            "host_prepare", "device_compute_readback", "request_decode",
            "batcher_forward", "batcher_answer"} | (
                {"batcher_slot_wait"} if app.native else set())
        health = app.health()
        assert health["weights"] == {"detector": "real", "pose": "real"}
        assert health["devices"] == ["cpu"]
    finally:
        app.shutdown()


def test_grpc_edge_on_artifact(restored):
    """The gRPC endpoint serves a restored artifact too: hbpe Estimate
    gives the HTTP route's answer."""
    import cv2

    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        GrpcClient,
        create_grpc_server,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    app = ServingApp(restored)
    server, port = create_grpc_server(app, "127.0.0.1", 0)
    server.start()
    try:
        ok, enc = cv2.imencode(".png", _images()[0][..., ::-1])
        assert ok
        client = GrpcClient(f"127.0.0.1:{port}")
        resp = client.estimate(enc.tobytes(), 175, 0.5)
        client.close()
        assert resp["code"] == "success"
        row = restored.infer_serving([_images()[0]], 175.0, 0.5)[0, 0]
        got = resp["body_proportion_lengths_(cm)"]
        assert bool(got) == bool(row[0])
        if row[0]:
            assert sum(not isinstance(v, str) for v in got.values()) == \
                int(row[12:].sum())
    finally:
        server.stop(0)
        app.shutdown()


def test_prewarm_on_artifact_pipeline(artifact_dir):
    """prewarm_serving warms an artifact at its one fixed batch: every
    count up to it pads to it."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        prewarm_serving,
    )

    pipe = ArtifactPipeline(artifact_dir, device="cpu")
    assert pipe.prewarmed is False
    assert prewarm_serving(pipe) == [1, 2, 4]
    assert pipe.prewarmed is True


def test_restore_builds_no_model(artifact_dir, monkeypatch):
    """Restoring and serving an artifact constructs no module of the port
    and reads no .npz: the program and its weights come from
    pipeline.pt2 alone."""
    built, loaded = [], []
    init = torch.nn.Module.__init__

    def counting_init(self, *a, **k):
        if type(self).__module__.startswith(
                "human_body_proportion_estimation_tpu_torch"):
            built.append(type(self).__name__)
        init(self, *a, **k)

    real_load = np.load

    def counting_load(path, *a, **k):
        loaded.append(str(path))
        return real_load(path, *a, **k)

    monkeypatch.setattr(torch.nn.Module, "__init__", counting_init)
    monkeypatch.setattr(np, "load", counting_load)
    pipe = ArtifactPipeline(artifact_dir, device="cpu")
    out = pipe.infer_serving(_images()[:2], 175.0, 0.5)
    assert out.shape == (2, 3, 23)
    assert built == [] and loaded == []


def test_artifact_format_version_gating(artifact_dir, tmp_path):
    """Restore refuses artifacts written by a NEWER format with the JAX
    package's message, and fails cleanly on a missing directory."""
    newer = tmp_path / "newer"
    shutil.copytree(artifact_dir, newer)
    meta_path = newer / "meta.json"
    meta = json.loads(meta_path.read_text())
    assert meta["format_version"] == 1
    meta["format_version"] = 99
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format_version 99") as exc:
        ServingArtifact(str(newer), device="cpu")
    assert str(exc.value) == (
        f"artifact {newer} has format_version 99; this build reads <= 1 — "
        "re-export with this build or upgrade it")
    with pytest.raises(FileNotFoundError):
        ServingArtifact(str(tmp_path / "does-not-exist"), device="cpu")


def test_artifact_refuses_another_device_type(artifact_dir, tmp_path):
    """An artifact serves on the device type it was exported on: restoring
    elsewhere raises and names both, before the program is read."""
    moved = tmp_path / "cuda"
    moved.mkdir()
    meta = json.loads(open(os.path.join(artifact_dir, "meta.json")).read())
    meta["device"] = "cuda"
    (moved / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="exported on cuda and cannot "
                                         "serve on cpu"):
        ArtifactPipeline(str(moved), device="cpu")
    with pytest.raises(ValueError, match="exported on cpu and cannot "
                                         "serve on cuda"):
        ServingArtifact(artifact_dir, device="cuda")


def test_mesh_is_not_ported_yet(artifact_dir):
    """A mesh is ported now (item 16): over a mesh of the CPU listed
    twice, one call takes the batch of both shards, and one program serves
    both (tests/test_torch_port_sharded_serving.py holds the rows)."""
    from human_body_proportion_estimation_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    sharded = ArtifactPipeline(artifact_dir,
                               mesh=make_mesh(devices=["cpu", "cpu"]))
    assert sharded.artifact.effective_batch == 2 * BATCH
    assert len({id(p) for p, _ in sharded.artifact.shards}) == 1


def test_registry_beside_an_artifact_matches_jax(restored):
    """The model registry beside an artifact shares no module: the port's
    builds every model as with no pipeline, in the artifact's
    configuration, as the JAX registry does beside a pipeline with no
    pose, no backend and no model."""
    from human_body_proportion_estimation_tpu.serve.registry import (
        build_registry as jbuild_registry,
    )
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        build_registry,
    )

    jcfg, _ = tiny.configs()
    stand_in = types.SimpleNamespace(
        config=jcfg, weights_origin=dict(restored.weights_origin), mesh=None)
    ref = jbuild_registry(stand_in, include=tiny.PORTED)
    got = build_registry(restored)
    keys = ("name", "version", "state", "weights")
    assert [{k: r[k] for k in keys} for r in got.index()] == [
        {k: r[k] for k in keys} for r in ref.index()]
    for name in tiny.PORTED:
        g, r = got.metadata(name), ref.metadata(name)
        g.pop("platform"), r.pop("platform")
        assert g == r, name
    got.shutdown()
    ref.shutdown()


def test_config_from_dict_matches_jax():
    """config_from_dict rebuilds the frozen tree of the JAX function from
    the same asdict, unknown keys dropped and lists turned to tuples."""
    from human_body_proportion_estimation_tpu.utils.config import (
        config_from_dict as jconfig_from_dict,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        config_from_dict,
    )

    jcfg, tcfg = tiny.configs()
    d = json.loads(json.dumps(dataclasses.asdict(tcfg)))
    assert d == json.loads(json.dumps(dataclasses.asdict(jcfg)))
    d["from_a_newer_writer"] = 1
    d["pose"]["also_new"] = [1, 2]
    got, ref = config_from_dict(d), jconfig_from_dict(d)
    assert got == tcfg
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert isinstance(got.pose.keypoint_thresholds, tuple)
    assert type(got).__module__.startswith(
        "human_body_proportion_estimation_tpu_torch")


# --------------------------------------------------------------------- #
# the export CLI and the server's flag


def test_export_cli_flags_are_the_jax_clis_and_cpu():
    from human_body_proportion_estimation_tpu.cli import (
        export_artifact as jcli,
    )
    from human_body_proportion_estimation_tpu_torch.cli import (
        export_artifact as tcli,
    )

    def options(parser):
        return {a.dest: (a.default, a.choices, a.required)
                for a in parser._actions if a.dest != "help"}

    jparser = _parser_of(jcli.main)
    got = options(tcli.build_parser())
    assert got.pop("cpu") == (False, None, False)
    assert got == options(jparser)


def _parser_of(main):
    """The argparse parser a JAX `main` builds, caught as it parses."""
    import argparse

    caught = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        caught["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["parser"]


@pytest.mark.parametrize("argv,item", [
    ([], DEFAULT_TFLITE_PATH),
    (["--detector", "efficientdet_lite4", "--checkpoint-dir", "x"],
     "the checkpoint's slots"),
])
def test_export_cli_exits_on_options_not_ported(argv, item, tmp_path,
                                                capsys, monkeypatch):
    """Before any model is built, exit 2 naming the reason: the JAX
    default detector (ssd_mobilenet) without the reference's ssd.tflite
    (absent here). --checkpoint-dir reads a checkpoint the JAX package
    wrote, with tensorstore kept from the port, into the pipeline the
    artifact is exported from."""
    from human_body_proportion_estimation_tpu_torch.cli import (
        export_artifact as tcli,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline import host
    from tests.torch_port_orbax import (
        block_tensorstore,
        jax_checkpoint,
        states_equal,
    )

    class Built(Exception):
        pass

    def built(**kw):
        raise Built(kw)

    if "--checkpoint-dir" in argv:
        det, pose = jax_checkpoint(str(tmp_path / "x"))
        block_tensorstore(monkeypatch)
        monkeypatch.setattr(host, "InferencePipeline", built)
        with pytest.raises(Built) as caught:
            tcli.main(["--out", str(tmp_path / "a"), "--cpu",
                       *[str(tmp_path / a) if a == "x" else a
                         for a in argv]])
        kw = caught.value.args[0]
        assert states_equal(kw["det_state"], flax_to_state_dict(det)), item
        assert states_equal(kw["pose_state"], flax_to_state_dict(pose))
        assert not (tmp_path / "a").exists()
        return
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--out", str(tmp_path / "a"), *argv])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err
    assert not (tmp_path / "a").exists()


def test_export_cli_writes_an_artifact(models, tmp_path, monkeypatch,
                                       capsys):
    """--cpu --detector yolov5m: the CLI builds the pipeline of its slot on
    the CPU in f32 (here stood in by the tiny pipeline, its detector
    labelled random), prints the JAX warning for the random slot and
    writes an artifact that restores and serves."""
    from human_body_proportion_estimation_tpu_torch.cli import (
        export_artifact as tcli,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline import host

    calls = []

    def stand_in(**kw):
        calls.append(kw)
        return types.SimpleNamespace(
            config=models.tcfg, device=torch.device("cpu"),
            program=models.tpipe.program,
            weights_origin={"detector": "random", "pose": "real"})

    monkeypatch.setattr(host, "InferencePipeline", stand_in)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    out = tmp_path / "art"
    tcli.main(["--cpu", "--detector", "yolov5m", "--batch-size", "2",
               "--out", str(out), "--compile-cache-dir",
               str(tmp_path / "cache")])
    # no --checkpoint-dir: no checkpoint slots, the JAX CLI's defaults
    assert calls == [dict(device="cpu", dtype=torch.float32,
                          detector="yolov5m", det_state=None,
                          pose_state=None)]
    assert build.BUILD_DIR == str(tmp_path / "cache")
    printed = capsys.readouterr().out
    assert ("WARNING: exporting RANDOM-INIT weights for detector — the "
            "artifact will serve garbage for that slot (recorded in "
            "meta.json weights_origin)") in printed
    assert f"exported serving artifact to {out} (detector=yolov5m, " \
           "batch_size=2)" in printed
    pipe = ArtifactPipeline(str(out), device="cpu")
    assert pipe.weights_origin == {"detector": "random", "pose": "real"}
    np.testing.assert_array_equal(
        pipe.infer_serving(_images()[:2], 175.0, 0.5),
        models.tpipe.infer_serving(_images()[:2], 175.0, 0.5))


def test_export_cli_default_detector_with_its_file(models, tmp_path,
                                                  monkeypatch, capsys):
    """With the reference's ssd.tflite present, the default invocation
    (--detector ssd_mobilenet, as the JAX CLI) passes the option check,
    builds the SSD slot's pipeline with no state (the pipeline reads the
    file; here stood in by the tiny pipeline, labelled as the SSD slot
    labels itself), warns of no random slot and writes an artifact that
    restores with those labels."""
    from human_body_proportion_estimation_tpu_torch.cli import (
        export_artifact as tcli,
    )
    from human_body_proportion_estimation_tpu_torch.models import (
        tflite_import,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline import host

    present = tmp_path / "ssd.tflite"
    present.write_bytes(b"")
    monkeypatch.setattr(tflite_import, "DEFAULT_TFLITE_PATH", str(present))
    calls = []
    origin = {"detector": "real", "pose": "synthetic-certified"}

    def stand_in(**kw):
        calls.append(kw)
        return types.SimpleNamespace(
            config=models.tcfg, device=torch.device("cpu"),
            program=models.tpipe.program, weights_origin=dict(origin))

    monkeypatch.setattr(host, "InferencePipeline", stand_in)
    out = tmp_path / "art"
    tcli.main(["--cpu", "--batch-size", "2", "--out", str(out)])
    assert calls == [dict(device="cpu", dtype=torch.float32,
                          detector="ssd_mobilenet", det_state=None,
                          pose_state=None)]
    printed = capsys.readouterr().out
    assert "WARNING" not in printed
    assert f"exported serving artifact to {out} (detector=ssd_mobilenet, " \
           "batch_size=2)" in printed
    assert ArtifactPipeline(str(out), device="cpu").weights_origin == origin


def test_server_artifact_dir_with_data_parallel_exits(artifact_dir, capsys):
    """`--data-parallel 2` is ported (item 16); with fewer than two CUDA
    devices (tests/conftest.py hides every GPU) it exits 2 naming them, before the artifact is
    restored."""
    from human_body_proportion_estimation_tpu_torch.serve import server

    with pytest.raises(SystemExit) as exc:
        server.main(["--artifact-dir", artifact_dir, "--data-parallel", "2",
                     "--grpc-port", "0"])
    assert exc.value.code == 2
    assert ("--data-parallel 2: 2 devices asked for, 0 CUDA devices "
            "available") in capsys.readouterr().err


def test_server_artifact_dir_builds_the_artifact_pipeline(artifact_dir,
                                                          monkeypatch,
                                                          capsys):
    """--artifact-dir restores the artifact on the GPU (never another
    pipeline; --detector is not read) and serves it under the detector
    name "artifact", with the JAX warning when no slot is "real"."""
    from human_body_proportion_estimation_tpu_torch.pipeline import export
    from human_body_proportion_estimation_tpu_torch.serve import server

    served = []

    def fake_pipeline(directory, device):
        assert device == "cuda"
        pipe = ArtifactPipeline(directory, device="cpu")
        pipe.weights_origin = {"detector": "random",
                               "pose": "synthetic-certified"}
        return pipe

    monkeypatch.setattr(export, "ArtifactPipeline", fake_pipeline)
    monkeypatch.setattr(server, "_serve",
                        lambda args, pipe: served.append((args, pipe)))
    monkeypatch.setattr(server, "build_pipeline", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    server.main(["--artifact-dir", artifact_dir, "--grpc-port", "0"])
    (args, pipe), = served
    assert isinstance(pipe, ArtifactPipeline)
    assert args.detector == "ssd_mobilenet"
    assert ("WARNING: artifact carries no real-weight slot ({'detector': "
            "'random', 'pose': 'synthetic-certified'}) — outputs are garbage "
            "(see /health 'weights')") in capsys.readouterr().out


# --------------------------------------------------------------------- #
# the registered ops


def _op_cases():
    rng = np.random.default_rng(5)
    hm = torch.from_numpy(rng.normal(0, 1, (6, 17, 12, 10)).astype(
        np.float32))
    zs = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
        torch.bfloat16) for s in ((2, 4, 4, 32), (2, 2, 2, 32))]
    w = torch.from_numpy(rng.normal(0, 0.2, (9 * 5, 32)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, (9 * 5,)).astype(np.float32))
    xy = rng.uniform(0, 50, (2, 40, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 30, (2, 40, 2)).astype(np.float32)], -1))
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (2, 40)).astype(
        np.float32), -1).copy())
    return {
        "decode_heatmaps": (torch.ops.hbpe.decode_heatmaps.default, (hm,),
                            lambda: kernels.decode_heatmaps_plain(hm)),
        "head_score_levels": (
            torch.ops.hbpe.head_score_levels.default,
            (zs, w, bias, 9, 5, 2),
            lambda: kernels.head_score_levels_plain(zs, w, bias, 9, 5, 2)),
        "nms_sweep": (torch.ops.hbpe.nms_sweep.default,
                      (boxes, scores, 0.5, False),
                      lambda: kernels.nms_sweep_plain(boxes, scores, 0.5)),
        "nms_sweep_plus1": (torch.ops.hbpe.nms_sweep.default,
                            (boxes, scores, 0.3, True),
                            lambda: kernels.nms_sweep_plain(boxes, scores,
                                                            0.3, True)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_registered_op_passes_opcheck(name):
    """Schema, fake implementation and dispatch of each hbpe op, as
    torch.library checks them, on CPU inputs."""
    op, args, _ = _op_cases()[name]
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_faketensor", "test_aot_dispatch_static"))


@pytest.mark.parametrize("name", list(_op_cases()))
def test_cpu_tensor_reaches_the_plain_version(name):
    """On CPU tensors each op is its plain version, exactly, and launches
    nothing; its fake implementation gives the same shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, plain = _op_cases()[name]
    kernels.reset_launch_counts()
    got, want = op(*args), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCHES, 0)
    with FakeTensorMode() as mode:
        fake_args = [
            [mode.from_tensor(t) for t in a] if isinstance(a, list)
            else mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args]
        fake = op(*fake_args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == [
        (w.shape, w.dtype) for w in want]


def test_wrappers_call_the_registered_ops(monkeypatch):
    """The public wrappers keep their names and signatures and go through
    the ops (one dispatch for the live path and the artifact)."""
    seen = []
    for name in ("decode_heatmaps", "head_score_levels", "nms_sweep"):
        attr = {"decode_heatmaps": "_decode_heatmaps_op",
                "head_score_levels": "_head_score_levels_op",
                "nms_sweep": "_nms_sweep_op"}[name]
        real = getattr(kernels, attr)
        monkeypatch.setattr(kernels, attr, lambda *a, _r=real, _n=name:
                            seen.append(_n) or _r(*a))
    cases = _op_cases()
    kernels.decode_heatmaps(*cases["decode_heatmaps"][1])
    zs, w, bias, a, c, p = cases["head_score_levels"][1]
    best, person = kernels.head_score_levels(zs, w, bias, a, c, p)
    kernels.head_score(zs[0], w, bias, a, c, p)
    kernels.nms_sweep(*cases["nms_sweep"][1][:3])
    assert seen == ["decode_heatmaps", "head_score_levels",
                    "head_score_levels", "nms_sweep"]
    assert best.shape == person.shape == (2, (16 + 4) * 9)
