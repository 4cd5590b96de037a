"""Data-parallel serving of the port (`parallel/mesh.py`, `mesh=` of
`InferencePipeline`, `BottomUpPipeline`, `ServingArtifact` /
`ArtifactPipeline`, the registry's dp, `serve.server --data-parallel`,
`parallel/multihost.py`) on the CPU, the counterpart of the JAX package's
tests/test_sharded_serving.py, tests/test_bottomup_sharded.py and
tests/test_multihost_serving.py.

A mesh of the CPU listed twice stands in for two devices: each shard runs
the whole forward on its own rows, so the rows must equal the one-device
pipeline's at rtol / atol 1e-4 (the tiny f32 models of
tests/torch_port_tiny.py and tests/test_torch_port_bottomup.py). The
two-process lockstep runs over gloo on localhost, each process a
`tests/torch_port_multihost_worker.py` (torch only), against this process
serving the same batch alone.

Each mesh path is also held against the JAX package's own on a dp = 2
mesh of the conftest's virtual CPU devices, over the same weights and
inputs: `InferencePipeline(mesh=)` (score-kernel detector in interpret
mode) under tests/test_torch_port_pipeline.py's rule (validity exact;
the segments whose keypoints' argmax is decisive: visibility exact, cm
to 1e-3), `BottomUpPipeline(mesh=)` under
tests/test_torch_port_bottomup.py's (validity, keypoints and visibility
exact, cm 1e-4), and the registry's sharded `hrnet` under
tests/test_torch_port_registry.py's (1e-3).
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_body_proportion_estimation_tpu.parallel import mesh as JM
from human_body_proportion_estimation_tpu.pipeline.bottomup import (
    BottomUpPipeline as JBottomUp,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from human_body_proportion_estimation_tpu_torch.parallel import mesh as M
from human_body_proportion_estimation_tpu_torch.pipeline.bottomup import (
    BottomUpPipeline,
)
from human_body_proportion_estimation_tpu_torch.pipeline.export import (
    ArtifactPipeline,
    ServingArtifact,
    export_serving_artifact,
)
from human_body_proportion_estimation_tpu_torch.pipeline.host import (
    InferencePipeline,
    prepare_batch,
)
from human_body_proportion_estimation_tpu_torch.serve import (
    registry as tregistry,
)
from tests import torch_port_tiny as tiny
from tests.test_torch_port_bottomup import (
    assert_outputs_close,
    make_pipelines as bottomup_pipelines,
    port_tiny_model,
)
from tests.test_torch_port_models import _port_edet_config, _port_hrnet_config
from tests.test_torch_port_pipeline import _decisive
from tests.tiny_models import tiny_edet_config, tiny_higherhrnet, \
    tiny_w32_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and
    beside the suite's other workers those threads oversubscribe the
    CPU: one thread for the module, the process's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return tiny.tiny_models()


def _states(m):
    return flax_to_state_dict(m.det_vars), flax_to_state_dict(m.pose_vars)


def _pipeline(m, mesh=None):
    det, pose = _states(m)
    return InferencePipeline(
        m.tcfg, det, pose, device="cpu",
        det_config=_port_edet_config(tiny_edet_config()),
        pose_config=_port_hrnet_config(tiny_w32_config()),
        dtype=torch.float32, mesh=mesh)


@pytest.fixture(scope="module")
def sharded(models):
    return _pipeline(models, M.make_mesh(devices=CPU2))


@pytest.fixture(scope="module")
def jax_sharded(models):
    """The JAX package's InferencePipeline over the same weights, dp = 2
    on the virtual CPU devices."""
    return tiny.jax_pipeline(models, JM.make_mesh(2))


def _images(n, seed=0):
    return [tiny.image(seed + i)[0] for i in range(n)]


def assert_rows_match_jax(got, jpipe, imgs, heights, threshold):
    """Packed rows against the JAX pipeline's on the same request, under
    tests/test_torch_port_pipeline.py's rule."""
    ref_img = jpipe.infer_images(imgs, heights, det_threshold=threshold,
                                 with_heatmaps=True)
    _, seg_ok = _decisive(ref_img)
    ref = np.asarray(jpipe.infer_serving(imgs, heights, threshold))
    assert got.shape == ref.shape
    assert seg_ok.sum() >= 3, "persons were found: not a vacuous match"
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 12:][seg_ok],
                                  ref[..., 12:][seg_ok])
    np.testing.assert_allclose(got[..., 1:12][seg_ok],
                               ref[..., 1:12][seg_ok], rtol=1e-3, atol=1e-3)


def test_sharded_serving_matches_single_device(models, sharded):
    """The dp = 2 rows equal the one-device pipeline's, and every shard
    ran the whole serving forward (two forwards a batch)."""
    calls = []
    program = sharded.shard_programs[0]
    assert all(p is program for p in sharded.shard_programs)  # one device
    hook = program.register_forward_hook(lambda *a: calls.append(1))
    try:
        imgs = _images(4)
        a = models.tpipe.infer_serving(imgs, 175.0, 0.0)
        b = sharded.infer_serving(imgs, 175.0, 0.0)
    finally:
        hook.remove()
    assert a.shape == b.shape == (4, 3, 23)
    assert len(calls) == 2
    np.testing.assert_allclose(b, a, **TOL)
    assert a[:, :, 0].sum() > 0   # persons were found: not a vacuous match


def test_sharded_serving_matches_jax_sharded(sharded, jax_sharded):
    """The dp = 2 rows against JAX's InferencePipeline(mesh=) at dp = 2."""
    imgs = _images(4)
    assert_rows_match_jax(sharded.infer_serving(imgs, 175.0, 0.0),
                          jax_sharded, imgs, 175.0, 0.0)


def test_sharded_outputs_match_single_device(models, sharded):
    imgs = _images(3, seed=5)
    a = models.tpipe.infer_images(imgs, 175.0, 0.0, with_heatmaps=True)
    b = sharded.infer_images(imgs, 175.0, 0.0, with_heatmaps=True)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(y, x, **TOL)


def test_sharded_batch_rounds_to_shard_multiple(sharded, monkeypatch):
    """3 images pad to 4 rows (a multiple of dp, at least dp); 1 image to
    2; the answer keeps the request's rows."""
    seen = []
    real = sharded._serving
    monkeypatch.setattr(sharded, "_serving", lambda shards: seen.append(
        [len(s[0]) for s in shards]) or real(shards))
    imgs = [np.random.default_rng(1).integers(0, 256, (100, 100, 3),
                                              dtype=np.uint8)] * 3
    out = sharded.infer_serving(imgs, 175.0, det_threshold=1.1)
    assert out.shape == (3, 3, 23)
    assert not np.any(out[:, :, 0] > 0.5)  # no persons at threshold 1.1
    assert sharded.infer_serving(imgs[:1], 175.0, 1.1).shape == (1, 3, 23)
    assert seen == [[2, 2], [1, 1]]
    assert M.pad_to_shards(3, 2) == 4 and M.pad_to_shards(1, 4) == 4


def test_bottomup_dp_sharded_matches_single_device():
    _, single, variables = bottomup_pipelines()
    sharded_bu = BottomUpPipeline(
        single.config, pose_state=flax_to_state_dict(variables),
        model=port_tiny_model(), device="cpu", dtype=torch.float32,
        mesh=M.make_mesh(devices=CPU2))
    sharded_bu.INPUT_HW = single.INPUT_HW
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
            for _ in range(3)]
    a = single.infer_serving(imgs, 175.0)
    b = sharded_bu.infer_serving(imgs, 175.0)
    assert a.shape == b.shape == (3, 3, 23)
    np.testing.assert_allclose(b, a, **TOL)
    for x, y in zip(single.infer_images(imgs), sharded_bu.infer_images(imgs)):
        np.testing.assert_allclose(y, x, **TOL)


def test_bottomup_dp_sharded_matches_jax_sharded():
    """BottomUpPipeline(mesh=) at dp = 2 against JAX's at dp = 2 on the
    same tiny HigherHRNet weights, under the bottom-up parity rule."""
    _, single, variables = bottomup_pipelines()
    ours = BottomUpPipeline(
        single.config, pose_state=flax_to_state_dict(variables),
        model=port_tiny_model(), device="cpu", dtype=torch.float32,
        mesh=M.make_mesh(devices=CPU2))
    theirs = JBottomUp(single.config, pose_vars=variables,
                       model=tiny_higherhrnet(jnp.float32),
                       mesh=JM.make_mesh(2))
    ours.INPUT_HW = theirs.INPUT_HW = single.INPUT_HW
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
            for _ in range(3)]
    got = ours.infer_serving(imgs, 175.0)
    ref = np.asarray(theirs.infer_serving(imgs, 175.0))
    assert got.shape == ref.shape == (3, 3, 23)
    assert ref[..., 0].sum() >= 3
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 12:], ref[..., 12:])
    np.testing.assert_allclose(got[..., 1:12], ref[..., 1:12], rtol=1e-4,
                               atol=1e-4)
    assert_outputs_close(ours.infer_images(imgs), theirs.infer_images(imgs))


@pytest.fixture(scope="module")
def artifact_dir(models, tmp_path_factory):
    return export_serving_artifact(
        models.tpipe, str(tmp_path_factory.mktemp("art") / "repo"),
        batch_size=1)


def test_sharded_artifact_matches_single_device(models, artifact_dir):
    """Restored over a dp = 2 mesh: one call takes batch_size x dp rows,
    the program is restored once for the one device, and the rows equal
    the one-device artifact's and the live pipeline's."""
    single = ArtifactPipeline(artifact_dir, device="cpu")
    sharded_art = ArtifactPipeline(artifact_dir,
                                   mesh=M.make_mesh(devices=CPU2))
    assert sharded_art.artifact.effective_batch == 2
    assert single.artifact.effective_batch == 1
    programs = {id(p) for p, _ in sharded_art.artifact.shards}
    assert len(programs) == 1
    imgs = _images(3, seed=2)
    a = single.infer_serving(imgs, 175.0, 0.0)
    b = sharded_art.infer_serving(imgs, 175.0, 0.0)
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(
        b, models.tpipe.infer_serving(imgs, 175.0, 0.0), **TOL)
    raw = sharded_art.artifact   # called directly: effective_batch rows
    batch, thr, heights, orig_hw, _ = prepare_batch(models.tcfg, imgs[:2],
                                                    175.0, 0.0, 2)
    np.testing.assert_allclose(raw(batch, thr, heights, orig_hw), a[:2],
                               **TOL)


def test_sharded_artifact_matches_jax_sharded(artifact_dir, jax_sharded):
    """The artifact restored over a dp = 2 mesh against JAX's live
    pipeline at dp = 2."""
    art = ArtifactPipeline(artifact_dir, mesh=M.make_mesh(devices=CPU2))
    imgs = _images(4, seed=2)
    assert_rows_match_jax(art.infer_serving(imgs, 175.0, 0.0), jax_sharded,
                          imgs, 175.0, 0.0)


def test_registry_dp_matches_jax_registry_dp(models, sharded):
    """The registry over the pipeline's dp = 2 mesh against JAX's
    registry over a dp = 2 mesh: the same instance_group.count and the
    sharded `hrnet` batch's heatmaps."""
    reg = tregistry.build_registry(sharded)
    jreg = tiny.jax_registry(models, JM.make_mesh(2), include=("hrnet",))
    assert reg.config("hrnet")["instance_group"] == \
        jreg.config("hrnet")["instance_group"]
    assert reg.config("hrnet")["instance_group"][0]["count"] == 2
    x = np.random.default_rng(4).random((3, 3, 64, 64), np.float32)
    try:
        got = reg.infer("hrnet", {"input": x})["output"]
        ref = np.asarray(jreg.infer("hrnet", {"input": x})["output"])
    finally:
        reg.shutdown()
        jreg.shutdown()
    assert got.shape == ref.shape == (3, 17, 16, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_registry_shards_over_the_pipeline_mesh(models, sharded):
    """`build_registry` takes the pipeline's mesh: the batched runners
    report its dp as `instance_group.count` and shard a batch over it,
    with the one-device registry's answers; the EfficientDet models stay
    on one device (count 1), as in JAX."""
    reg = tregistry.build_registry(sharded)
    single = tregistry.build_registry(models.tpipe)
    for name in ("hrnet", "higherhrnet", "yolov5m", "yolov5s"):
        assert reg.config(name)["instance_group"][0]["count"] == 2, name
        assert single.config(name)["instance_group"][0]["count"] == 1
    assert reg.config("edetlite4")["instance_group"][0]["count"] == 1
    x = np.random.default_rng(3).random((3, 3, 64, 64), np.float32)
    try:
        a = single.infer("hrnet", {"input": x})["output"]
        b = reg.infer("hrnet", {"input": x})["output"]
    finally:
        reg.shutdown()
        single.shutdown()
    assert a.shape == b.shape == (3, 17, 16, 16)
    np.testing.assert_allclose(b, a, **TOL)
    assert tregistry._pad_rows(3, 4, 2) == 4
    assert tregistry._pad_rows(1, 4, 2) == 2
    assert tregistry._pad_rows(5, 16, 1) == 8


@pytest.mark.parametrize("argv,build", [
    (["--data-parallel", "2", "--detector", "efficientdet_lite4"],
     "build_pipeline"),
    (["--data-parallel", "2", "--bottom-up"], "build_bottomup_pipeline"),
    (["--data-parallel", "2", "--artifact-dir", "x"],
     "build_artifact_pipeline"),
])
def test_server_data_parallel_builds_each_branch_over_a_mesh(
        argv, build, monkeypatch):
    """`--data-parallel 2` builds a dp = 2 mesh before any model and hands
    it to the branch's build function (the live pipeline, --bottom-up,
    --artifact-dir), as the JAX server does."""
    from human_body_proportion_estimation_tpu_torch.serve import server

    seen = {}

    def fake_build(*args):
        seen["mesh"] = args[-1]
        raise SystemExit(0)

    monkeypatch.setattr(M, "make_mesh", lambda n: M.Mesh(
        np.array([[torch.device("cpu")]] * n, dtype=object)))
    monkeypatch.setattr(server, build, fake_build)
    with pytest.raises(SystemExit):
        server.main([*argv, "--grpc-port", "0"])
    assert seen["mesh"].shape == {"data": 2, "model": 1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_run(models, artifact_dir, tmp_path_factory):
    """Two worker processes over gloo, both phases (live pipeline, then
    the restored artifact) in one spawn; returns the coordinator's rows."""
    tmp = tmp_path_factory.mktemp("multihost")
    det, pose = _states(models)
    spec = dict(config=dataclasses.asdict(models.tcfg),
                det_config=_port_edet_config(tiny_edet_config()),
                pose_config=_port_hrnet_config(tiny_w32_config()),
                det_state=det, pose_state=pose, artifact_dir=artifact_dir,
                batch=_batch(models))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port_multihost_worker",
         str(pid), "2", str(port), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return (np.load(tmp / "live.npy"), np.load(tmp / "art.npy"), logs)


def _request():
    """4 images (a multiple of the 2-process mesh) and their heights."""
    return _images(4, seed=8), [[170.0], [180.0, 160.0], [175.0], [150.0]]


def _batch(m):
    """The request, prepared."""
    *arrays, _ = prepare_batch(m.tcfg, *_request(), 0.0, 4)
    return arrays


def test_two_process_serving_matches_single_process(models, multihost_run):
    live, _, logs = multihost_run
    ref = models.tpipe.serving_rows(*_batch(models))
    assert live.shape == ref.shape == (4, 3, 23)
    np.testing.assert_allclose(live, ref, **TOL)
    assert ref[:, :, 0].sum() > 0
    assert "worker live OK" in logs[1] and "coordinator live OK" in logs[0]


def test_two_process_serving_matches_jax_sharded(models, multihost_run,
                                                 jax_sharded):
    """The two processes' rows, live and restored, against JAX's dp = 2
    pipeline on the same request (the artifact served its first 2)."""
    live, art, _ = multihost_run
    imgs, heights = _request()
    assert_rows_match_jax(live, jax_sharded, imgs, heights, 0.0)
    assert_rows_match_jax(art, jax_sharded, imgs[:2], heights[:2], 0.0)


def test_two_process_artifact_serving_matches_single_process(
        models, artifact_dir, multihost_run):
    _, art, logs = multihost_run
    ref = ServingArtifact(artifact_dir, device="cpu")
    rows = np.concatenate([ref(*(a[i:i + 1] for a in _batch(models)))
                           for i in range(2)])
    assert art.shape == (2, 3, 23)
    np.testing.assert_allclose(art, rows, **TOL)
    assert "worker artifact OK" in logs[1]
