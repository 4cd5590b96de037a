"""The YOLO and bottom-up serving artifacts of the port
(`pipeline/export.py`) on the CPU against their live pipelines: the
counterparts of the JAX package's
`test_yolo_backend_export_restore_matches_live` and
`test_bottomup_export_restore_matches_live` (tests/test_export_artifact.py),
beside tests/test_torch_port_export.py so that the two files run on two
workers.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.pipeline.export import (
    ArtifactPipeline,
    export_serving_artifact,
)
from tests import torch_port_tiny as tiny
from tests.test_torch_port_export import _program_ops


def test_yolo_backend_export_restore_matches_live(tmp_path):
    """The YOLO detector slot exports too (letterbox -> decode -> the NMS
    op, all in the graph): the reduced seeded YOLOv5 at 128x128 behind the
    tiny HRNet, B = 2, restored rows equal to the live pipeline's, one NMS
    call in the program and none of the EfficientDet ops."""
    from human_body_proportion_estimation_tpu_torch.pipeline.backends import (
        YoloBackend,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.full import (
        ServingProgram,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from tests.test_torch_port_yolo import _tiny_pose
    from tests.torch_port_yolo import (
        TINY,
        TINY_SIZE,
        configs,
        model_inputs,
        port_model,
        seeded,
    )

    _, ycfg = configs(**TINY)
    images = np.random.default_rng(20).integers(
        0, 256, (2, TINY_SIZE, TINY_SIZE, 3), dtype=np.uint8)
    state = seeded(ycfg, 20, model_inputs(images, TINY_SIZE))
    _, _, pose_state, pose_cfg = _tiny_pose()
    _, tcfg = tiny.configs()
    tcfg = dataclasses.replace(
        tcfg, detector=dataclasses.replace(tcfg.detector, name="yolov5s"))
    live = InferencePipeline(tcfg, None, pose_state, device="cpu",
                             pose_config=pose_cfg, dtype=torch.float32,
                             detector="yolov5s")
    live.backend = YoloBackend(port_model(ycfg, state), tcfg,
                               input_size=TINY_SIZE)
    live.program = ServingProgram(tcfg, live.backend, live.pose)
    d = export_serving_artifact(live, str(tmp_path / "yolo"), batch_size=2)
    assert _program_ops(d) == ["hbpe.nms_sweep.default",
                               "hbpe.decode_heatmaps.default"]

    imgs = list(images)
    want = live.infer_serving(imgs, 175.0, 0.45)
    pipe = ArtifactPipeline(d, device="cpu")
    assert pipe.config.detector.name == "yolov5s"
    got = pipe.infer_serving(imgs, 175.0, 0.45)
    assert want[..., 0].sum() >= 2, "the shaped biases must yield persons"
    np.testing.assert_array_equal(got, want)


def test_bottomup_export_restore_matches_live(tmp_path):
    """Bottom-up artifact (mode bottom_up in meta, the JAX keys): the
    restored program (the AE decode inside, no hbpe op) reproduces the
    live BottomUpPipeline's packed rows, and ArtifactPipeline cuts 3 images
    into chunks of 2."""
    from tests.test_torch_port_bottomup import make_pipelines, sample_images

    _, live, _ = make_pipelines(person_score_threshold=0.0)
    d = export_serving_artifact(live, str(tmp_path / "bu"), batch_size=2)
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["mode"] == "bottom_up" and meta["input_hw"] == [128, 128]
    assert meta["grouping"] == {"max_cands": 8, "tag_threshold": 1.0,
                                "score_threshold": 0.1}
    assert _program_ops(d) == []

    imgs = sample_images(2)
    want = live.infer_serving(imgs, person_heights=175.0)
    pipe = ArtifactPipeline(d, device="cpu")
    assert pipe.artifact.mode == "bottom_up"
    assert pipe.weights_origin == {"pose": "real"}
    got = pipe.infer_serving(imgs, person_heights=175.0)
    assert want[..., 0].sum() >= 1
    np.testing.assert_array_equal(got, want)

    out = pipe.infer_serving([imgs[0]] * 3, person_heights=175.0)
    assert out.shape[0] == 3
    np.testing.assert_array_equal(out[0], out[2])
    np.testing.assert_array_equal(out[0], got[0])


def test_export_cli_bottom_up_writes_an_artifact(tmp_path, monkeypatch,
                                                 capsys):
    """`cli.export_artifact --bottom-up --cpu` exports the pipeline
    `pipeline.bottomup.build_default` gives (here the tiny one, at random),
    with the JAX warning for a random HigherHRNet and mode bottom_up; the
    default --detector ssd_mobilenet is not read."""
    from human_body_proportion_estimation_tpu_torch.cli import (
        export_artifact as tcli,
    )
    from human_body_proportion_estimation_tpu_torch.ops import build
    from human_body_proportion_estimation_tpu_torch.pipeline import bottomup
    from tests.test_torch_port_bottomup import make_pipelines, sample_images

    _, live, _ = make_pipelines(person_score_threshold=0.0)
    live.weights_origin = {"pose": "random"}
    calls = []
    monkeypatch.setattr(bottomup, "build_default",
                        lambda **kw: calls.append(kw) or live)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    out = tmp_path / "bu"
    tcli.main(["--bottom-up", "--cpu", "--batch-size", "2", "--out",
               str(out)])
    assert calls == [dict(device="cpu", dtype=torch.float32)]
    printed = capsys.readouterr().out
    assert ("WARNING: exporting RANDOM-INIT HigherHRNet — the artifact will "
            "serve garbage (recorded in meta.json weights_origin)") in printed
    assert f"exported bottom-up serving artifact to {out} (batch_size=2)" \
        in printed
    pipe = ArtifactPipeline(str(out), device="cpu")
    assert pipe.artifact.mode == "bottom_up"
    assert pipe.weights_origin == {"pose": "random"}
    imgs = sample_images(2)
    np.testing.assert_array_equal(pipe.infer_serving(imgs, 175.0),
                                  live.infer_serving(imgs, 175.0))
