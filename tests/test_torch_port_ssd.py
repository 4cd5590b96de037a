"""The port's SSD-MobileNetV1 slot against the JAX package's, at full width
(MobileNetV1-0.75 at 300x300, 1917 anchors), on the CPU:

- flax's init draw: the port's `models.flax_init` of `SSDMobileNetV1`
  bit-equal to flax's `init` (PRNGKey(0)), leaf for leaf;
- the forward from one flax tree (`tests.torch_port_ssd.seeded_ssd`, the
  seed of ssd_goldens.json, on the scenes): f32 within 1e-4 of the peak;
  bf16 on both sides, each held to the f32 flax output, the port's error
  of the size of flax's own (mean within 1.5x, max within 3x);
- `ssd_postprocess` on a batch (one NMS sweep call) equal to JAX's
  per-image function: planted score ties (the lower anchor first), a
  class tie (the lower class), a class-89 box, an image whose scores are
  all below the 1e-8 threshold; classes and validity exact, boxes and
  scores to 1e-6;
- `InferencePipeline(detector="ssd_mobilenet")` (`SSDBackend`) against JAX
  `InferencePipeline(backend=SSDBackend(cfg))` on the scenes with the
  seeded weights and a tiny HRNet pose (f32): the same persons, boxes to
  1e-3 px, packed rows to 1e-3; one NMS sweep call a batch;
- the registry's `ssd_mobilenet` entry on the same weights against JAX's
  `_ssd_entry` (classes and counts exact, boxes and scores to 1e-5);
- the SSD slot's serving artifact, exported and restored, row for row
  the live pipeline's;
- `load_ssd` from a state, from a tflite and with the file absent;
- `HumanDetectorSSD` on a tflite written by tests/torch_port_tflite.py
  (the seeded weights quantized to uint8) against JAX's, which reads the
  same file through `tf.lite.Interpreter`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import (
    ssd_mobilenet as jssd,
)
from human_body_proportion_estimation_tpu_torch.models import (
    ssd_mobilenet as tssd,
)
from human_body_proportion_estimation_tpu_torch.ops import kernels
from tests.test_torch_port_ssd_goldens import GOLDEN, scenes
from tests.torch_port_ssd import seeded_ssd, ssd_anchors, ssd_inputs

F32 = dict(rtol=0, atol=1e-6)      # the postprocess on the same outputs
NET = dict(rtol=0, atol=1e-5)      # forward + postprocess, f32 stacks


@pytest.fixture(scope="module")
def seeded():
    """(flax tree, anchors, scenes, det threshold) of ssd_goldens.json."""
    import json

    with open(GOLDEN) as fh:
        golden = json.load(fh)
    images = scenes()
    return (seeded_ssd(golden["seed"], images, golden["person_bias"]),
            ssd_anchors(), images, golden["det_threshold"])


def port_model(tree, dtype=torch.float32):
    model = tssd.SSDMobileNetV1(dtype=dtype).eval()
    state = tssd.ssd_state_dict(tree, np.zeros((1917, 4), np.float32))
    state.pop("anchors")
    model.load_state_dict(state, strict=True)
    return model


def test_ssd_flax_init_draw_is_flax():
    from human_body_proportion_estimation_tpu_torch.models.flax_init import (
        init_state_dict,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
    )

    jm = jssd.SSDMobileNetV1(dtype=jnp.float32)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3)))))
    got = init_state_dict(tssd.SSDMobileNetV1(), 0)
    assert sorted(got) == sorted(ref) and len(got) == 94
    for key in ref:
        assert torch.equal(got[key], ref[key]), key


def test_ssd_forward_matches_flax(seeded):
    tree, _, images, _ = seeded
    x = ssd_inputs(images)
    ref = [np.asarray(t) for t in jax.jit(
        jssd.SSDMobileNetV1(dtype=jnp.float32).apply)(tree, x)]
    ref16 = [np.asarray(t) for t in jax.jit(
        jssd.SSDMobileNetV1(dtype=jnp.bfloat16).apply)(tree, x)]
    with torch.inference_mode():
        got = [t.numpy() for t in port_model(tree)(torch.from_numpy(x))]
        got16 = [t.numpy() for t in port_model(tree, torch.bfloat16)(
            torch.from_numpy(x))]
    for name, r, g, r16, g16 in zip(("box_regs", "logits"), ref, got, ref16,
                                    got16):
        assert g.shape == r.shape and g.dtype == g16.dtype == np.float32
        peak = np.abs(r).max()
        assert np.abs(g - r).max() <= 1e-4 * peak, name
        err_port, err_flax = np.abs(g16 - r), np.abs(r16 - r)
        assert err_port.mean() <= 1.5 * err_flax.mean(), name
        assert err_port.max() <= 3.0 * err_flax.max(), name


def planted_outputs():
    """Raw outputs of 3 images with planted ties, a class-89 box and an
    image whose every score is under the threshold."""
    rng = np.random.default_rng(5)
    br = rng.normal(0, 1, (3, 1917, 4)).astype(np.float32)
    lg = rng.normal(-3, 2, (3, 1917, 91)).astype(np.float32)
    lg[0, 100] = lg[0, 40]           # two anchors with equal scores
    br[0, 100] = br[0, 40]           # ... and equal boxes: one suppressed
    lg[0, 7, 1:] = -9.0
    lg[0, 7, [5, 9]] = 6.0           # a class tie: the lower class wins
    lg[1, 1500, 1:] = -9.0
    lg[1, 1500, 90] = 8.0            # class 89 (COCO's last), the top box
    lg[2] = -40.0                    # sigmoid < 1e-8: nothing valid
    return br, lg


def test_ssd_postprocess_matches_jax(monkeypatch):
    br, lg = planted_outputs()
    anchors = ssd_anchors()
    calls = []
    plain = kernels.nms_sweep
    monkeypatch.setattr(kernels, "nms_sweep", lambda b, s, t, plus1=False: (
        calls.append(tuple(b.shape)) or plain(b, s, t, plus1=plus1)))
    got = tssd.ssd_postprocess(torch.from_numpy(br), torch.from_numpy(lg),
                               torch.from_numpy(anchors))
    assert calls == [(3, 128, 4)]
    for i in range(3):
        ref = jssd.ssd_postprocess(jnp.asarray(br[i]), jnp.asarray(lg[i]),
                                   jnp.asarray(anchors))
        np.testing.assert_array_equal(got.valid[i].numpy(), ref.valid)
        np.testing.assert_array_equal(got.classes[i].numpy(), ref.classes)
        np.testing.assert_allclose(got.boxes[i].numpy(), ref.boxes, **F32)
        np.testing.assert_allclose(got.scores[i].numpy(), ref.scores, **F32)
    assert got.valid[0].sum() == 10 and not got.valid[2].any()
    assert got.classes[1, 0] == 89 and 4 in got.classes[0].tolist()
    # one image ([1917, ...]) keeps the JAX signature
    one = tssd.ssd_postprocess(torch.from_numpy(br[1]),
                               torch.from_numpy(lg[1]),
                               torch.from_numpy(anchors))
    assert torch.equal(one.boxes, got.boxes[1])


@pytest.fixture(scope="module")
def pipelines(seeded):
    """The JAX and the port SSD pipelines (f32, tiny HRNet pose, 64x64
    crops) over the seeded weights."""
    from human_body_proportion_estimation_tpu.models.hrnet import (
        HRNet as JHRNet,
    )
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        SSDBackend as JSSDBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline as JPipeline,
    )
    from human_body_proportion_estimation_tpu.utils.config import (
        DetectorConfig as JDetectorConfig,
        PipelineConfig as JPipelineConfig,
        PoseConfig as JPoseConfig,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.utils.config import (
        DetectorConfig,
        PipelineConfig,
        PoseConfig,
    )
    from tests.test_torch_port_models import (
        _port_hrnet_config,
        _randomize_bn,
    )
    from tests.tiny_models import tiny_w32_config
    from tests.torch_port_tiny import _filled

    tree, anchors, _, _ = seeded
    pose = dict(crop_height=64, crop_width=64, heatmap_height=16,
                heatmap_width=16)
    jcfg = JPipelineConfig(detector=JDetectorConfig(name="ssd_mobilenet"),
                           pose=JPoseConfig(**pose))
    tcfg = PipelineConfig(detector=DetectorConfig(name="ssd_mobilenet"),
                          pose=PoseConfig(**pose))
    jpose = JHRNet(config=tiny_w32_config(), dtype=jnp.float32)
    pose_vars = _randomize_bn(_filled(jpose, (64, 64), 1), 11)
    det_vars = {"params": tree["params"], "anchors": jnp.asarray(anchors)}
    jpipe = JPipeline(config=jcfg, backend=JSSDBackend(jcfg, jnp.float32),
                      pose=jpose, det_vars=det_vars, pose_vars=pose_vars)
    tpipe = InferencePipeline(
        tcfg, tssd.ssd_state_dict(tree, anchors),
        flax_to_state_dict(pose_vars), device="cpu",
        pose_config=_port_hrnet_config(tiny_w32_config()),
        dtype=torch.float32)
    return jpipe, tpipe, det_vars


def test_ssd_pipeline_matches_jax(pipelines, seeded, monkeypatch):
    jpipe, tpipe, _ = pipelines
    _, _, images, thres = seeded
    assert tpipe.weights_origin["detector"] == "real"
    calls = []
    plain = kernels.nms_sweep
    monkeypatch.setattr(kernels, "nms_sweep", lambda b, s, t, plus1=False: (
        calls.append(tuple(b.shape)) or plain(b, s, t, plus1=plus1)))
    got = tpipe.infer_images(list(images), 175.0, thres)
    rows = tpipe.infer_serving(list(images), 175.0, thres)
    assert calls == [(4, 128, 4)] * 2   # one sweep a batch (padded to 4)
    for i, img in enumerate(images):
        ref = jpipe.infer_images([img], 175.0, thres)
        np.testing.assert_array_equal(got.person_valid[i],
                                      ref.person_valid[0])
        assert got.person_valid[i].any()
        np.testing.assert_allclose(got.boxes_orig[i], ref.boxes_orig[0],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.det_scores[i], ref.det_scores[0],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            rows[i], jpipe.infer_serving([img], 175.0, thres)[0],
            rtol=1e-3, atol=1e-3)


def test_ssd_registry_entry_matches_jax(pipelines, seeded):
    from human_body_proportion_estimation_tpu.serve.registry import (
        _ssd_entry as jentry,
    )
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        build_registry,
    )

    jpipe, tpipe, det_vars = pipelines
    _, _, images, _ = seeded
    treg = build_registry(tpipe)
    assert treg.metadata("ssd_mobilenet")["platform"] == "pytorch"
    ref_entry = jentry(jpipe.config, jssd.SSDMobileNetV1(dtype=jnp.float32),
                       det_vars)
    run = ref_entry.build()
    for img in (images[0], images[2][:300, :300]):
        got = treg.infer("ssd_mobilenet", {"image": img[None]})
        ref = run({"image": img[None]})
        assert list(got) == list(ref)
        np.testing.assert_array_equal(got["detection_classes"],
                                      ref["detection_classes"])
        np.testing.assert_array_equal(got["num_detections"],
                                      ref["num_detections"])
        for k in ("detection_boxes", "detection_scores"):
            np.testing.assert_allclose(got[k], ref[k], **NET)
    # the entry runs the pipeline's own SSD module
    assert treg._get("ssd_mobilenet").runner is not None
    treg.shutdown()


def test_ssd_export_restore_matches_live(pipelines, seeded, tmp_path):
    """The SSD slot's serving artifact (`pipeline/export.py`): the resize
    to 300x300, the SSD, `ssd_postprocess` with its class-offset NMS op
    and the pose in one exported graph. Restored, its rows equal the live
    pipeline's exactly (f32, B = 4 as the live bucket of 3 images); the
    program calls the NMS op once and the decode once, and none of the
    EfficientDet ops."""
    from human_body_proportion_estimation_tpu_torch.pipeline.export import (
        ArtifactPipeline,
        export_serving_artifact,
    )
    from tests.test_torch_port_export import _program_ops

    _, tpipe, _ = pipelines
    _, _, images, thres = seeded
    d = export_serving_artifact(tpipe, str(tmp_path / "ssd"), batch_size=4)
    assert _program_ops(d) == ["hbpe.nms_sweep.default",
                               "hbpe.decode_heatmaps.default"]
    want = tpipe.infer_serving(list(images), 175.0, thres)
    pipe = ArtifactPipeline(d, device="cpu")
    assert pipe.config.detector.name == "ssd_mobilenet"
    assert pipe.weights_origin == tpipe.weights_origin
    got = pipe.infer_serving(list(images), 175.0, thres)
    assert want[..., 0].sum() >= len(images)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["state", "tflite", "absent"])
def test_load_ssd_sources(seeded, tmp_path, monkeypatch, source):
    """`models.ssd_mobilenet.load_ssd`, the one loader of the pipeline,
    the registry and `HumanDetectorSSD`: from a state (its anchor table
    split off), from a tflite (the path given, else the default path,
    bf16 by default), and with the default file absent, the ValueError
    that names it."""
    import re

    from human_body_proportion_estimation_tpu_torch.models import (
        tflite_import as ttfl,
    )
    from tests.torch_port_tflite import ssd_tensors, write_tflite

    tree, anchors, _, _ = seeded
    if source == "absent":
        path = str(tmp_path / "absent" / "ssd.tflite")
        monkeypatch.setattr(ttfl, "DEFAULT_TFLITE_PATH", path)
        with pytest.raises(ValueError, match=re.escape(path)):
            tssd.load_ssd(device="cpu")
        return
    if source == "state":
        want = tssd.ssd_state_dict(tree, anchors)
        model, table = tssd.load_ssd(want, dtype=torch.float32, device="cpu")
        assert "anchors" in want   # the caller's state is left whole
    else:
        path = write_tflite(str(tmp_path / "ssd.tflite"),
                            ssd_tensors(tree["params"], anchors))
        want = tssd.ssd_state_dict(*ttfl.load_ssd_weights(path))
        monkeypatch.setattr(ttfl, "DEFAULT_TFLITE_PATH", path)
        model, table = tssd.load_ssd(device="cpu")
        assert model.dtype == torch.bfloat16
        given, _ = tssd.load_ssd(path=path, dtype=torch.float32,
                                 device="cpu")
        assert given.dtype == torch.float32
        for key, value in given.state_dict().items():
            assert torch.equal(value, model.state_dict()[key]), key
    assert not model.training and table.dtype == torch.float32
    assert torch.equal(table, want["anchors"])
    got = model.state_dict()
    assert sorted(got) == sorted(k for k in want if k != "anchors")
    for key, value in got.items():
        assert torch.equal(value, want[key]), key


def test_human_detector_matches_jax_on_a_written_tflite(seeded, tmp_path):
    from human_body_proportion_estimation_tpu.pipeline.human_detector import (
        HumanDetectorSSD as JDetector,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.human_detector import (  # noqa: E501
        HumanDetectorSSD,
    )
    from tests.torch_port_tflite import ssd_tensors, write_tflite

    tree, anchors, images, _ = seeded
    path = write_tflite(str(tmp_path / "ssd.tflite"),
                        ssd_tensors(tree["params"], anchors))
    ref = JDetector(tflite_path=path, threshold=0.3)
    got = HumanDetectorSSD(tflite_path=path, threshold=0.3, device="cpu")
    for img in images:
        (gb, gs), (rb, rs) = got.get_detections(img), ref.get_detections(img)
        assert len(gb) == len(rb) >= 1
        np.testing.assert_allclose(gb, rb, **NET)
        np.testing.assert_allclose(gs, rs, **NET)
        crops, ref_crops = got.get_crops(img), ref.get_crops(img)
        assert [c.shape for c in crops] == [c.shape for c in ref_crops]
