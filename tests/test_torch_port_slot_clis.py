"""The port's `cli/detect_edet.py` and `cli/pose_est.py` against the JAX
package's on the CPU, on tiny models with the same weights: in process
(both packages' random initializations replaced by the same variables,
both sides in float32), and in remote mode (`-g`) against the port's gRPC
edge, whose answers must equal the registry's own forward. Then the
flags: both `main`s pass the same arguments for the same command line.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_body_proportion_estimation_tpu.cli import (
    detect_edet as jdetect,
    pose_est as jpose,
)
from human_body_proportion_estimation_tpu.models import (
    efficientdet as jedet,
    higherhrnet as jhh,
    hrnet as jhrnet,
)
from human_body_proportion_estimation_tpu_torch.cli import (
    detect_edet as tdetect,
    pose_est as tpose,
)
from human_body_proportion_estimation_tpu_torch.models import (
    efficientdet as tedet,
    higherhrnet as thh,
    hrnet as thrnet,
    layers as tlayers,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from tests.test_torch_port_models import _port_hrnet_config, _randomize_bn
from tests.tiny_models import tiny_w32_config
from tests.torch_port_tiny import _filled, tiny_models

TOL = dict(rtol=1e-4, atol=1e-4)
DET_HW = (128, 128)


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """One 128x128 image file (the tiny detector's input size, so that no
    resize stands between the remote and the in-process runs)."""
    import cv2

    img = np.random.default_rng(60).integers(0, 256, (*DET_HW, 3),
                                             dtype=np.uint8)
    path = tmp_path_factory.mktemp("media") / "frame.png"
    cv2.imwrite(str(path), img[..., ::-1])
    return str(path)


def _load(state):
    """A stand-in for `models.layers.init_random` that loads `state`."""
    def load(model):
        model.load_state_dict(state, strict=True)
        return model
    return load


def _tiny_detectors(monkeypatch, m):
    """Both CLIs' EfficientDet slots (Lite4 and Lite0 alike) become the
    tiny detector of tests/torch_port_tiny.py in f32 with its weights."""
    jcfg = m.jdet.config
    for name in ("EFFICIENTDET_LITE0", "EFFICIENTDET_LITE4"):
        monkeypatch.setattr(jedet, name, jcfg)
        monkeypatch.setattr(tedet, name, m.tpipe.backend.detector.config)
    plain = jedet.EfficientDet
    monkeypatch.setattr(jedet, "EfficientDet",
                        functools.partial(plain, dtype=jnp.float32))
    monkeypatch.setattr(plain, "init", lambda self, *a, **k: m.det_vars)
    monkeypatch.setattr(tlayers, "init_random",
                        _load(flax_to_state_dict(m.det_vars)))


# --------------------------------------------------------------------- #
# detect_edet


@pytest.mark.parametrize("detector", ["efficientdet_lite4",
                                      "efficientdet_lite0"])
def test_detect_edet_in_process_matches_jax(monkeypatch, tiny, frame,
                                            tmp_path, detector):
    """`run_demo_odet` of both packages on one image: the detections at
    or above the threshold (boxes to 1e-3 px, scores to 1e-4, classes
    exact) and the rendered file names."""
    _tiny_detectors(monkeypatch, tiny)
    kw = dict(det_threshold=0.5, detector_name=detector, debug=False,
              input_hw=DET_HW)
    (ref,) = jdetect.run_demo_odet(frame, save_result_dir=str(
        tmp_path / "jax"), **kw)
    (got,) = tdetect.run_demo_odet(frame, save_result_dir=str(
        tmp_path / "port"), device="cpu", dtype=torch.float32, **kw)
    assert 0 < len(got[0]) == len(ref[0])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])
    sub = f"tpu_{detector}"
    assert os.listdir(tmp_path / "port" / sub) == os.listdir(
        tmp_path / "jax" / sub) == ["frame_000000.jpg"]


def _grpc_app(pipe):
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        create_grpc_server,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )

    app = ServingApp(pipe)
    server, port = create_grpc_server(app, "127.0.0.1", 0)
    server.start()
    return app, server, port


def test_detect_edet_remote_mode_equals_in_process(monkeypatch, tiny, frame):
    """`-g`: the port's gRPC edge serves `edetlite4` on the serving
    pipeline's detector; the CLI's detections equal its in-process
    run on the same weights."""
    pytest.importorskip("grpc")
    _tiny_detectors(monkeypatch, tiny)
    app, server, port = _grpc_app(tiny.tpipe)
    try:
        (remote,) = tdetect.run_demo_odet(frame, det_threshold=0.5,
                                          debug=False, input_hw=DET_HW,
                                          grpc_target=str(port))
    finally:
        server.stop(0)
        app.shutdown()
    (local,) = tdetect.run_demo_odet(frame, det_threshold=0.5, debug=False,
                                     input_hw=DET_HW, device="cpu",
                                     dtype=torch.float32)
    assert len(local[0]) > 0
    for r, loc in zip(remote, local):
        np.testing.assert_allclose(r, loc, rtol=0, atol=1e-5)


# --------------------------------------------------------------------- #
# pose_est


def _tiny_pose(name):
    """(JAX module, port module factory, variables) of the reduced-depth
    pose model of a `--model` name."""
    w = 48 if name == "hrnet_w48" else 32
    jcfg = dataclasses.replace(tiny_w32_config(), width=w)
    tcfg = _port_hrnet_config(jcfg)
    if name == "higherhrnet":
        jm = jhh.HigherHRNetHeatmaps(config=jcfg, dtype=jnp.float32)

        def make(dtype=torch.bfloat16, cls=thh.HigherHRNetHeatmaps):
            return cls(tcfg, dtype=dtype)
    else:
        jm = jhrnet.HRNet(config=jcfg, dtype=jnp.float32)

        def make(dtype=torch.bfloat16):
            return thrnet.HRNet(tcfg, dtype=dtype)
    variables = _randomize_bn(_filled(jm, (64, 64), 61), 62)
    return jm, make, variables


@pytest.mark.parametrize("name", ["hrnet_w32", "hrnet_w48", "higherhrnet"])
def test_pose_est_in_process_matches_jax(monkeypatch, frame, tmp_path, name):
    """`run_demo_pose_est` of both packages on one image at the 288x384
    input: heatmaps to 1e-4, keypoints exact, scores to 1e-4, and the
    rendered file names."""
    jm, make, variables = _tiny_pose(name)
    monkeypatch.setattr(jhrnet, "create_hrnet", lambda n: jm)
    monkeypatch.setattr(jhh, "HigherHRNetHeatmaps", lambda: jm)
    monkeypatch.setattr(type(jm), "init", lambda self, *a, **k: variables)
    monkeypatch.setattr(thrnet, "create_hrnet",
                        lambda n, dtype: make(dtype))
    monkeypatch.setattr(thh, "HigherHRNetHeatmaps", make)
    monkeypatch.setattr(tlayers, "init_random",
                        _load(flax_to_state_dict(variables)))
    (ref,) = jpose.run_demo_pose_est(frame, model_name=name, debug=False,
                                     save_result_dir=str(tmp_path / "jax"))
    (got,) = tpose.run_demo_pose_est(frame, model_name=name, debug=False,
                                     save_result_dir=str(tmp_path / "port"),
                                     device="cpu", dtype=torch.float32)
    kp, scores, heatmap = got
    scale = 2 if name == "higherhrnet" else 4
    assert heatmap.shape == (17, 384 // scale, 288 // scale)
    np.testing.assert_allclose(heatmap, ref[2], **TOL)
    np.testing.assert_array_equal(kp, ref[0])
    np.testing.assert_allclose(scores, ref[1], **TOL)
    sub = f"tpu_{name}"
    assert sorted(os.listdir(tmp_path / "port" / sub)) == sorted(
        os.listdir(tmp_path / "jax" / sub)) == ["frame_000000.jpg",
                                                "heatmap_000000.jpg"]


@pytest.mark.parametrize("name", ["hrnet_w32", "higherhrnet"])
def test_pose_est_remote_mode_equals_the_registry_forward(tiny, frame, name):
    """`-g`: the CLI sizes its input from the named model's metadata
    (the 64x64 crops of the tiny `hrnet`; 512x512 for `higherhrnet`'s
    dynamic dims), sends it, and decodes the heatmaps that come back as
    the JAX CLI does; the answer equals the registry's forward of the
    same input."""
    pytest.importorskip("grpc")
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.pose import (
        preprocess_crop_host,
    )
    from tests import torch_port_tiny

    pipe = tiny.tpipe
    if name == "higherhrnet":
        _, tcfg = torch_port_tiny.configs()
        tcfg = dataclasses.replace(tcfg, pose=dataclasses.replace(
            tcfg.pose, name="higherhrnet", heatmap_height=32,
            heatmap_width=32))
        _, _, variables = _tiny_pose(name)
        pipe = InferencePipeline(
            tcfg, flax_to_state_dict(tiny.det_vars),
            flax_to_state_dict(variables), device="cpu",
            det_config=tiny.tpipe.backend.detector.config,
            pose_config=_port_hrnet_config(tiny_w32_config()),
            dtype=torch.float32)
    app, server, port = _grpc_app(pipe)
    try:
        (remote,) = tpose.run_demo_pose_est(frame, model_name=name,
                                            debug=False,
                                            grpc_target=str(port))
        reg_name, out = (("higherhrnet", "output_2") if name == "higherhrnet"
                         else ("hrnet", "output"))
        size = 512 if name == "higherhrnet" else 64
        import cv2

        img = cv2.imread(frame)[..., ::-1]
        x = preprocess_crop_host(img, size, size)[None].transpose(0, 3, 1, 2)
        hm = app.registry.infer(reg_name, {"input": np.ascontiguousarray(
            x)})[out]
    finally:
        server.stop(0)
        app.shutdown()
    kp, scores, heatmap = remote
    np.testing.assert_array_equal(heatmap, hm[0])
    ref_kp, ref_scores = jpose._decode_heatmaps_np(hm)
    np.testing.assert_array_equal(kp, ref_kp[0])
    np.testing.assert_array_equal(scores, ref_scores[0])


def test_decode_heatmaps_np_matches_jax():
    """The host argmax decode of remote heatmaps: first index on ties,
    x = idx % w, y = idx // w, no zeroing of non-positive maxima."""
    hm = np.random.default_rng(63).normal(size=(2, 17, 12, 9)).astype(
        np.float32)
    hm[0, 3, 5, 2] = hm[0, 3, 7, 1] = 9.0
    hm[1, 4] = -np.abs(hm[1, 4]) - 1.0
    got, ref = tpose._decode_heatmaps_np(hm), jpose._decode_heatmaps_np(hm)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0][0, 3].tolist() == [2.0, 5.0]


# --------------------------------------------------------------------- #
# flags


@pytest.mark.parametrize("argv", [
    ["detect_edet", "-i", "d", "--detector", "efficientdet_lite0", "-t",
     "0.3", "-g", "8081", "-m", "video", "-o", ""],
    ["pose_est", "-i", "d", "--model", "higherhrnet", "-g", "host:1"],
    ["pose_est", "-i", "d", "--model", "hrnet_w48", "-o", "out"],
])
def test_cli_mains_pass_the_jax_arguments(monkeypatch, argv):
    """The same command line gives the same call of `run_demo_odet` /
    `run_demo_pose_est` in both packages (the port's parsers take the JAX
    ones' flags, `--model` choices included)."""
    calls = {}
    for side, module in (("jax", {"detect_edet": jdetect,
                                  "pose_est": jpose}[argv[0]]),
                         ("port", {"detect_edet": tdetect,
                                   "pose_est": tpose}[argv[0]])):
        fn = ("run_demo_odet" if argv[0] == "detect_edet"
              else "run_demo_pose_est")
        monkeypatch.setattr(module, fn, lambda *a, side=side, **k:
                            calls.__setitem__(side, (a, k)) or [])
        monkeypatch.setattr(sys, "argv", [argv[0], *argv[1:],
                                          "--no-compile-cache"])
        module.main()
    assert calls["port"] == calls["jax"]
    with pytest.raises(SystemExit):
        monkeypatch.setattr(sys, "argv", [argv[0], "-i", "d", "--model",
                                          "nope"])
        tpose.main()
