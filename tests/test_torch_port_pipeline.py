"""The port's whole slice — `InferencePipeline(device="cpu")`: EfficientDet
with the head-score kernel's plain version, person slots with the NMS
sweep's, crop, HRNet, decode, centimetres — against the JAX
`InferencePipeline` with `EfficientDet(score_kernel=True,
score_kernel_interpret=True)`, on the same weights.

Tiny shapes (128x128 det input, 64x64 crops, 16x16 heatmaps) and the
depth-reduced models of tests/tiny_models.py, both sides in float32. The
class-0 bias of `class_net/predict_pw` is raised in the flax params before
both sides load them, so that real person slots come out of random
weights. Person validity must agree exactly and continuous outputs
(boxes, scores, heatmaps) to 1e-3 (the head-score product rounds its
inputs to bf16 on both sides, see test_torch_port_models). Random pose
weights give flat heatmaps whose argmax an f32 round-off can move, so the
argmax-derived outputs (keypoints, visibility, lengths) are compared
exactly on the maps whose top two values are more than 1e-3 apart — most
of them — and the test requires that most are.

Known divergence (ROADMAP.md section 3): for a box that reaches the far
image edge (normalized y2 or x2 == 1.0), the JAX pipeline's jit-compiled
crop drops the last crop row/column (XLA fuses the sampling-position
arithmetic and rounds it past in-1, so TF's in-range test fails), while
the port — like the JAX op run eagerly — samples the edge pixel there.
Pose outputs are compared on the slots whose boxes stay off the far edges;
`test_crop_far_edge_row_follows_the_eager_op` pins the difference down.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import efficientdet as jedet
from human_body_proportion_estimation_tpu.models.hrnet import HRNet as JHRNet
from human_body_proportion_estimation_tpu.pipeline.backends import (
    EfficientDetBackend as JBackend,
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
    InferencePipeline as TPipeline,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    DetectorConfig,
    PipelineConfig,
    PoseConfig,
)
from tests.test_torch_port_models import (
    _port_edet_config,
    _port_hrnet_config,
    _randomize_bn,
)
from human_body_proportion_estimation_tpu_torch.ops.proportions import (
    _REQUIRED,
)
from tests.tiny_models import tiny_edet_config, tiny_w32_config

DET_HW, CROP_HW, HM_HW = (128, 128), (64, 64), (16, 16)
PERSON_BIAS = 4.0


def _configs():
    det = dict(input_height=DET_HW[0], input_width=DET_HW[1])
    pose = dict(crop_height=CROP_HW[0], crop_width=CROP_HW[1],
                heatmap_height=HM_HW[0], heatmap_width=HM_HW[1])
    return (
        JPipelineConfig(detector=JDetectorConfig(**det),
                        pose=JPoseConfig(**pose)),
        PipelineConfig(detector=DetectorConfig(**det), pose=PoseConfig(**pose)),
    )


@pytest.fixture(scope="module")
def pipelines():
    jcfg, tcfg = _configs()
    jdet_cfg, jpose_cfg = tiny_edet_config(), tiny_w32_config()
    jdet = jedet.EfficientDet(config=jdet_cfg, dtype=jnp.float32,
                              score_kernel=True, score_kernel_interpret=True,
                              person_class0=0)
    jpose = JHRNet(config=jpose_cfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    det_vars = _randomize_bn(jdet.init(
        key, jnp.zeros((1, *DET_HW, 3), jnp.float32)), 10)
    pose_vars = _randomize_bn(jpose.init(
        key, jnp.zeros((1, *CROP_HW, 3), jnp.float32)), 11)
    nc = jdet_cfg.num_classes
    det_vars["params"]["class_net"]["predict_pw"]["bias"][::nc] += PERSON_BIAS

    jpipe = JPipeline(config=jcfg, backend=JBackend(jdet, jcfg), pose=jpose,
                      det_vars=det_vars, pose_vars=pose_vars)
    tpipe = TPipeline(
        tcfg, flax_to_state_dict(det_vars), flax_to_state_dict(pose_vars),
        device="cpu", det_config=_port_edet_config(jdet_cfg),
        pose_config=_port_hrnet_config(jpose_cfg), dtype=torch.float32,
    )
    return jpipe, tpipe


def _images():
    rng = np.random.default_rng(12)
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in [(150, 100, 3), (128, 128, 3), (90, 200, 3)]]


def _decisive(ref):
    """Masks of the (slot, keypoint) maps whose argmax is decisive (top-two
    gap > 1e-3) on slots whose crop stays off the far image edges, and of
    the segments whose keypoints all are."""
    hm = np.asarray(ref.heatmaps)
    flat = np.sort(hm.reshape(*hm.shape[:3], -1), axis=-1)
    off_edge = np.all(np.asarray(ref.boxes_norm)[..., 2:] < 1.0, -1)
    kp_ok = ((flat[..., -1] - flat[..., -2]) > 1e-3) & off_edge[..., None]
    seg_ok = np.all(np.where(_REQUIRED, kp_ok[..., None, :], True), -1)
    return kp_ok, seg_ok


@pytest.fixture(scope="module")
def outputs(pipelines):
    jpipe, tpipe = pipelines
    heights = [[170.0], [180.0, 160.0], [175.0]]
    ref = jpipe.infer_images(_images(), heights, det_threshold=0.5,
                             with_heatmaps=True)
    got = tpipe.infer_images(_images(), heights, det_threshold=0.5,
                             with_heatmaps=True)
    return ref, got


def test_slice_outputs_match_jax(outputs):
    ref, got = outputs
    valid = np.asarray(ref.person_valid)
    assert valid.sum() >= 3, "the raised person bias must yield persons"
    np.testing.assert_array_equal(got.person_valid, valid)
    for name in ("det_scores", "boxes_norm", "boxes_orig"):
        np.testing.assert_allclose(
            getattr(got, name), np.asarray(getattr(ref, name)),
            rtol=1e-3, atol=1e-3, err_msg=name)
    off_edge = np.all(np.asarray(ref.boxes_norm)[..., 2:] < 1.0, -1)
    assert (valid & off_edge).sum() >= 3
    for name in ("kp_scores", "heatmaps"):
        np.testing.assert_allclose(
            getattr(got, name)[off_edge],
            np.asarray(getattr(ref, name))[off_edge],
            rtol=1e-3, atol=1e-3, err_msg=name)

    kp_ok, seg_ok = _decisive(ref)
    assert kp_ok[valid & off_edge].mean() > 0.8
    np.testing.assert_allclose(got.keypoints[kp_ok],
                               np.asarray(ref.keypoints)[kp_ok],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.kp_visible[kp_ok],
                                  np.asarray(ref.kp_visible)[kp_ok])
    np.testing.assert_array_equal(got.seg_visible[seg_ok],
                                  np.asarray(ref.seg_visible)[seg_ok])
    np.testing.assert_allclose(got.lengths_cm[seg_ok],
                               np.asarray(ref.lengths_cm)[seg_ok],
                               rtol=1e-3, atol=1e-3)


def test_slice_packed_serving_matches_jax(pipelines, outputs):
    jpipe, tpipe = pipelines
    _, seg_ok = _decisive(outputs[0])
    ref = np.asarray(jpipe.infer_serving(_images(), [[170.0], [180.0, 160.0],
                                                     [175.0]], 0.5))
    got = tpipe.infer_serving(_images(), [[170.0], [180.0, 160.0], [175.0]],
                              0.5)
    assert got.shape == ref.shape == (3, 3, 23)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_array_equal(got[..., 12:][seg_ok], ref[..., 12:][seg_ok])
    np.testing.assert_allclose(got[..., 1:12][seg_ok], ref[..., 1:12][seg_ok],
                               rtol=1e-3, atol=1e-3)


def test_slice_infer_bytes_json_matches_jax(pipelines):
    import io

    from PIL import Image

    from human_body_proportion_estimation_tpu_torch.ops.proportions import (
        SEGMENT_NAMES,
    )

    jpipe, tpipe = pipelines
    ref_img = jpipe.infer_images(_images()[:1], 172.0, det_threshold=0.5,
                                 with_heatmaps=True)
    _, seg_ok = _decisive(ref_img)
    buf = io.BytesIO()
    Image.fromarray(_images()[0]).save(buf, format="PNG")
    ref = jpipe.infer_bytes(buf.getvalue(), 172.0, det_threshold=0.5)
    got = tpipe.infer_bytes(buf.getvalue(), 172.0, det_threshold=0.5)
    assert got["code"] == ref["code"] == "success"
    assert got["msg"] == ref["msg"]
    r, g = ref["body_proportion_lengths_(cm)"], got[
        "body_proportion_lengths_(cm)"]
    assert list(g) == list(r) == SEGMENT_NAMES
    for s_i, name in enumerate(r):
        if not seg_ok[0, 0, s_i]:
            continue
        if isinstance(r[name], str):
            assert g[name] == r[name]
        else:
            assert g[name] == pytest.approx(r[name], rel=1e-3, abs=1e-3)
    json.dumps(got)   # the response is plain JSON

    bad = tpipe.infer_bytes(b"not an image")
    assert bad["code"] == "failed" == jpipe.infer_bytes(b"xx")["code"]


def test_crop_far_edge_row_follows_the_eager_op():
    """The documented divergence, pinned down: at a box reaching the far
    image edge the port's crop equals the JAX op run eagerly (TF
    semantics: the last crop row samples the edge pixel), while the same
    op under jax.jit returns a zero last row; every other row agrees to
    the crop's f32 tolerance (1e-4)."""
    from human_body_proportion_estimation_tpu.ops import crop as jcrop
    from human_body_proportion_estimation_tpu_torch.ops import crop as tcrop

    img = np.random.default_rng(0).uniform(0, 1, (128, 128, 3)).astype(
        np.float32)
    box = np.array([[0.35432574, 0.48389053, 1.0, 1.0]], np.float32)
    eager = np.asarray(jcrop.crop_and_resize(jnp.asarray(img),
                                             jnp.asarray(box), 64, 64))
    jitted = np.asarray(jax.jit(
        lambda i, b: jcrop.crop_and_resize(i, b, 64, 64))(
            jnp.asarray(img), jnp.asarray(box)))
    got = tcrop.crop_and_resize(torch.from_numpy(img),
                                torch.from_numpy(box), 64, 64).numpy()
    np.testing.assert_allclose(got, eager, rtol=1e-4, atol=1e-4)
    assert np.abs(got[0, -1]).sum() > 0 and np.abs(got[0, :, -1]).sum() > 0
    if np.abs(jitted[0, -1]).sum() == 0:      # the divergence, while it lasts
        np.testing.assert_allclose(got[0, :-1, :-1], jitted[0, :-1, :-1],
                                   rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, jitted, rtol=1e-4, atol=1e-4)
