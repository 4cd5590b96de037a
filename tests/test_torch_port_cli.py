"""The port's main-path CLI against the JAX package's, on the CPU.

`run_pdet_pose` of both packages over one directory of 2 images, on the
tiny pipelines of tests/test_torch_port_pipeline.py (the same flax-init
weights): the same nested result list `[[boxes, heatmaps, dist_dict_p0,
...], ...]`, boxes and heatmaps to 1e-3 (the tolerance of
`test_slice_outputs_match_jax`), cm dicts as in tests/test_torch_port_serve.py
(decisive segments, 1e-3), and the same rendered file names. Then the
flags: the port's `build_parser` takes the JAX one's option strings, and
`build_pipeline` exits on the options it does not serve yet and builds the
Lite0 slot.
"""

import os

import numpy as np
import pytest

from human_body_proportion_estimation_tpu.cli.args import (
    build_parser as jbuild_parser,
)
from human_body_proportion_estimation_tpu.cli.detect_pose import (
    run_pdet_pose as jrun,
)
from human_body_proportion_estimation_tpu_torch.cli.args import build_parser
from human_body_proportion_estimation_tpu_torch.ops import build
from human_body_proportion_estimation_tpu_torch.cli.common import (
    build_pipeline,
)
from human_body_proportion_estimation_tpu_torch.cli.detect_pose import (
    run_pdet_pose,
)
from tests.test_torch_port_pipeline import pipelines  # noqa: F401
from tests.test_torch_port_serve import (
    assert_cm_close,
    decisive_segments,
    images,
)

TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def runs(pipelines, tmp_path_factory):  # noqa: F811
    import cv2

    jpipe, tpipe = pipelines
    media = tmp_path_factory.mktemp("media")
    imgs = images()[:2]
    for i, img in enumerate(imgs):
        cv2.imwrite(str(media / f"img_{i}.png"), img[..., ::-1])
    out = {}
    for name, fn, pipe in (("jax", jrun, jpipe), ("port", run_pdet_pose,
                                                  tpipe)):
        save = tmp_path_factory.mktemp(f"out_{name}")
        results = fn(str(media), person_height=[172.0], det_threshold=0.5,
                     save_result_dir=str(save), pipeline=pipe, debug=False)
        out[name] = (results, sorted(os.listdir(save / "tpu_pdet_pose")))
    return out, decisive_segments(tpipe, imgs), tpipe.infer_images(
        imgs, 172.0, det_threshold=0.5).boxes_norm


def test_run_pdet_pose_matches_jax(runs):
    out, seg_ok, boxes_norm = runs
    (ref, _), (got, _) = out["jax"], out["port"]
    assert len(got) == len(ref) == 2
    checked = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert len(g) == len(r) >= 3, "every image must have a person"
        np.testing.assert_allclose(g[0], np.asarray(r[0]), **TOL)
        nper = len(r) - 2
        off_edge = np.all(boxes_norm[i, :nper, 2:] < 1.0 - 1e-3, -1)
        assert g[1].shape == np.asarray(r[1]).shape
        np.testing.assert_allclose(g[1][off_edge],
                                   np.asarray(r[1])[off_edge], **TOL)
        for slot in range(nper):
            checked += assert_cm_close(g[2 + slot], r[2 + slot],
                                       seg_ok[i, slot])
    assert checked >= 3


def test_run_pdet_pose_writes_the_jax_file_names(runs):
    out, _, _ = runs
    names = out["port"][1]
    assert names == out["jax"][1]
    assert [n for n in names if n.startswith("frame_")] == [
        "frame_000000.jpg", "frame_000001.jpg"]
    assert any(n.startswith("heatmap_") for n in names)


def test_build_parser_takes_the_jax_options(monkeypatch):
    # the compile cache flags repoint the process's build directory: put
    # it back afterwards
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    def options(parser):
        return sorted(s for a in parser._actions for s in a.option_strings)

    assert options(build_parser("x")) == options(jbuild_parser("x"))
    args = build_parser("x").parse_args(
        ["-i", "d", "-t", "0.5", "-p", "180", "--no-compile-cache"])
    ref = jbuild_parser("x").parse_args(
        ["-i", "d", "-t", "0.5", "-p", "180", "--no-compile-cache"])
    assert vars(args) == vars(ref)


@pytest.mark.parametrize("argv", [
    ["-i", "d", "--checkpoint-dir", "ckpt"],
    ["-i", "d", "--detector", "efficientdet_lite0"],
])
def test_build_pipeline_exits_on_options_not_ported(argv, capsys,
                                                    monkeypatch):
    """--checkpoint-dir exits 2 naming the tensorstore package on a
    machine without it (hidden here), before anything is built. The Lite0
    slot: the pipeline is built (here on the CPU) with the JAX CLI's
    weights, the certified HRNet-W32 and the detector at random."""
    from human_body_proportion_estimation_tpu_torch.cli import common
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE0,
    )

    if "efficientdet_lite0" in argv:
        plain = common.InferencePipeline
        monkeypatch.setattr(common, "InferencePipeline",
                            lambda **kw: plain(**{**kw, "device": "cpu"}))
        pipe = build_pipeline(build_parser("x").parse_args(argv))
        assert pipe.weights_origin == {"detector": "random",
                                       "pose": "synthetic-certified"}
        assert pipe.backend.detector.config == EFFICIENTDET_LITE0
        return
    monkeypatch.setattr(common, "has_tensorstore", lambda: False)
    with pytest.raises(SystemExit) as exc:
        build_pipeline(build_parser("x").parse_args(argv))
    assert exc.value.code == 2
    assert "needs the tensorstore package" in capsys.readouterr().err
