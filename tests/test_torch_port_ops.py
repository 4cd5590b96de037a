"""The port's ops (boxes, anchors, NMS, crop, heatmap, proportions,
select_persons) against the JAX package's functions on the same numpy
inputs. Each comparison states its tolerance: exact where both sides do
the same f32 operations in the same order, 1e-4 for the matmul crop (f32
sums in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import anchors as janchors
from human_body_proportion_estimation_tpu.ops import (
    boxes as jboxes,
    crop as jcrop,
    heatmap as jheatmap,
    nms as jnms,
    proportions as jprop,
)
from human_body_proportion_estimation_tpu.pipeline.full import (
    select_persons as jselect_persons,
)
from human_body_proportion_estimation_tpu_torch.models import (
    anchors as tanchors,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    boxes as tboxes,
    crop as tcrop,
    heatmap as theatmap,
    nms as tnms,
    proportions as tprop,
)
from human_body_proportion_estimation_tpu_torch.pipeline.full import (
    select_persons as tselect_persons,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PoseConfig,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_xyxy(rng, n, lo=0.0, hi=300.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(0.0, 150.0, (n, 2))
    wh[: n // 8] = 0.0  # zero-area boxes
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_iou_exact():
    rng = np.random.default_rng(0)
    a, b = _random_xyxy(rng, 40), _random_xyxy(rng, 30)
    ref = np.asarray(jboxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tboxes.box_iou(_t(a), _t(b)).numpy(), ref)


def test_xyxy_xywh_roundtrip_matches_jax():
    """`xyxy2xywh` equals JAX's (tests/test_ops_boxes.py:17's boxes) bit
    for bit, and back through `xywh2xyxy` within its tolerances."""
    rng = np.random.default_rng(17)
    x1y1 = rng.uniform(0, 300, (64, 2))
    b = np.concatenate([x1y1, x1y1 + rng.uniform(1, 200, (64, 2))],
                       -1).astype(np.float32)
    got = tboxes.xyxy2xywh(_t(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jboxes.xyxy2xywh(jnp.asarray(b))))
    np.testing.assert_allclose(tboxes.xywh2xyxy(got).numpy(), b,
                               rtol=1e-5, atol=1e-4)


def test_expand_clip_normalize_exact():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-50, 700, (4, 3, 4)).astype(np.float32)
    ref = np.asarray(jboxes.expand_clip_normalize_yxyx(
        jnp.asarray(boxes), jnp.float32(37.0), jnp.float32(0.0), 480, 640))
    got = tboxes.expand_clip_normalize_yxyx(_t(boxes), 37.0, 0.0, 480, 640)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw", [(480, 640), (128, 96)])
def test_generate_anchors_identical(hw):
    cfg = janchors.AnchorConfig()
    ref = janchors.generate_anchors(cfg, *hw)
    got = tanchors.generate_anchors(tanchors.AnchorConfig(), *hw)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,levels", [((640, 640), (3, 7)),
                                       ((320, 320), (3, 7)),
                                       ((480, 640), (3, 7)),
                                       ((97, 133), (2, 6))])
def test_feature_shapes_identical(hw, levels):
    """Each level's (H, W), rounded up, as JAX's; `generate_anchors` lays
    one cell of anchors on each of their points."""
    ref = janchors.feature_shapes(janchors.AnchorConfig(*levels), *hw)
    cfg = tanchors.AnchorConfig(*levels)
    got = tanchors.feature_shapes(cfg, *hw)
    assert got == ref and all(isinstance(v, int) for s in got for v in s)
    n = len(tanchors.generate_anchors(cfg, *hw))
    assert n == sum(h * w for h, w in got) * cfg.anchors_per_cell


def test_decode_boxes_matches():
    """1e-5 relative: exp() may differ by an ulp between XLA and ATen."""
    rng = np.random.default_rng(2)
    anchors = janchors.generate_anchors(janchors.AnchorConfig(), 128, 128)
    regs = rng.normal(0, 0.5, anchors.shape).astype(np.float32)
    ref = np.asarray(janchors.decode_boxes(jnp.asarray(regs),
                                           jnp.asarray(anchors)))
    got = tanchors.decode_boxes(_t(regs), _t(anchors)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("t", [0.5, 0.3])
def test_nms_mask_exact(t):
    rng = np.random.default_rng(3)
    boxes = _random_xyxy(rng, 64)
    scores = np.sort(rng.uniform(0, 1, 64).astype(np.float32))[::-1].copy()
    scores[-6:] = 0.0  # dead rows
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), t))
    got = tnms.nms_mask(_t(boxes), _t(scores), t).numpy()
    np.testing.assert_array_equal(got, ref)


def test_crop_and_resize_matches():
    """1e-4: f32 matmul crops, sums in another order. Boxes reach outside
    the image (zero extrapolation) and include a zero-area box."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    boxes = np.array([
        [0.1, 0.2, 0.8, 0.9],
        [-0.3, -0.2, 0.5, 1.4],      # reaches outside the image
        [0.4, 0.4, 0.4, 0.4],        # zero area
        [0.9, 0.7, 1.6, 1.2],
    ], np.float32)
    ref = np.asarray(jcrop.crop_and_resize(jnp.asarray(img),
                                           jnp.asarray(boxes), 24, 18))
    got = tcrop.crop_and_resize(_t(img), _t(boxes), 24, 18).numpy()
    assert got.shape == (4, 24, 18, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # batched form equals the per-image form
    got_b = tcrop.crop_and_resize(_t(img)[None].repeat(2, 1, 1, 1),
                                  _t(boxes)[None].repeat(2, 1, 1), 24, 18)
    np.testing.assert_allclose(got_b[1].numpy(), got, rtol=1e-6, atol=1e-6)


def test_decode_heatmaps_ties_and_negative_exact():
    rng = np.random.default_rng(5)
    hm = rng.normal(0, 1, (2, 3, 17, 16, 12)).astype(np.float32)
    hm[0, 0, 0] = 0.0
    hm[0, 0, 0, 3, 4] = hm[0, 0, 0, 9, 1] = 2.0      # tie: first wins
    hm[1, 2] = -np.abs(hm[1, 2]) - 0.5                # all-negative person
    ref_kp, ref_sc = jheatmap.decode_heatmaps(jnp.asarray(hm))
    kp, sc = theatmap.decode_heatmaps(_t(hm))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ref_kp))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(ref_sc))
    assert kp[0, 0, 0].tolist() == [4.0, 3.0]
    assert np.all(kp[1, 2].numpy() == 0.0)


def test_refine_remap_gate_match():
    rng = np.random.default_rng(6)
    hm = rng.normal(0, 1, (2, 3, 17, 16, 12)).astype(np.float32)
    kp, sc = jheatmap.decode_heatmaps(jnp.asarray(hm))
    ref = np.asarray(jheatmap.refine_subpixel(kp, jnp.asarray(hm)))
    got = theatmap.refine_subpixel(_t(np.asarray(kp)), _t(hm)).numpy()
    np.testing.assert_array_equal(got, ref)

    boxes = rng.uniform(0, 600, (2, 3, 4)).astype(np.float32)
    ref = np.asarray(jheatmap.remap_to_image(kp, jnp.asarray(boxes), (16, 12)))
    got = theatmap.remap_to_image(_t(np.asarray(kp)), _t(boxes),
                                  (16, 12)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)

    thr = PoseConfig().keypoint_thresholds
    ref = np.asarray(jheatmap.gate_keypoints(sc, thr))
    got = theatmap.gate_keypoints(_t(np.asarray(sc)), thr).numpy()
    np.testing.assert_array_equal(got, ref)


def test_segment_lengths_and_dict_match():
    """1e-5 relative: the endpoint matmul and norm are f32 on both sides."""
    rng = np.random.default_rng(7)
    kp = rng.uniform(0, 400, (2, 3, 17, 2)).astype(np.float32)
    kp[0, 1, 5] = kp[0, 1, 6]                 # zero-length shoulder
    vis = rng.uniform(0, 1, (2, 3, 17)) > 0.2
    scale = rng.uniform(0.2, 0.6, (2, 3)).astype(np.float32)
    ref = jprop.segment_lengths(jnp.asarray(kp), jnp.asarray(vis),
                                jnp.asarray(scale))
    got = tprop.segment_lengths(_t(kp), _t(vis), _t(scale))
    np.testing.assert_array_equal(got.visible.numpy(),
                                  np.asarray(ref.visible))
    np.testing.assert_allclose(got.lengths_cm.numpy(),
                               np.asarray(ref.lengths_cm),
                               rtol=1e-5, atol=1e-4)
    assert tprop.SEGMENT_NAMES == jprop.SEGMENT_NAMES
    lengths, v = got.lengths_cm.numpy()[0, 0], got.visible.numpy()[0, 0]
    assert tprop.to_dist_dict(lengths, v) == jprop.to_dist_dict(lengths, v)


def test_select_persons_matches_with_ties():
    """Stable top-k: among equal (zero) scores the lower index comes first,
    as `jax.lax.top_k` orders them."""
    boxes = np.arange(48, dtype=np.float32).reshape(2, 6, 4)
    scores = np.array([[0.9, 0.85, 0.8, 0.75, 0.6, 0.5],
                       [0.2, 0.9, 0.9, 0.1, 0.0, 0.0]], np.float32)
    classes = np.array([[1, 2, 1, 1, 1, 1], [1, 1, 1, 3, 1, 1]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    thres = np.array([0.7, 0.5], np.float32)
    got = tselect_persons(_t(boxes), _t(scores), _t(classes), _t(valid),
                          _t(thres), 1, 3)
    for i in range(2):
        ref = jselect_persons(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(classes[i]), jnp.asarray(valid[i]),
            jnp.float32(thres[i]), 1, 3)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))


def _nms_fixed_inputs(seed, n, n_classes=6):
    rng = np.random.default_rng(seed)
    boxes = _random_xyxy(rng, n, hi=200.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[rng.uniform(0, 1, n) < 0.2] = 0.0            # dead candidates
    scores[5:9] = scores[4]                              # ties
    classes = rng.integers(0, n_classes, n).astype(np.float32)
    return boxes, scores, classes


@pytest.mark.parametrize("n_classes,top_k,max_det", [
    (1, 64, 100), (6, 64, 100), (6, 128, 40), (6, 256, 300),
], ids=["one_class", "per_class", "max_det_below_k", "top_k_above_n"])
def test_nms_fixed_matches_jax(n_classes, top_k, max_det):
    """Exact: the same stable top-k (the lower index first among equal
    scores, as `jax.lax.top_k`), the same class offset, keep mask and
    compaction, padded slots zeroed."""
    boxes, scores, classes = _nms_fixed_inputs(8, 200, n_classes)
    ref = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                         max_det=max_det, top_k=top_k,
                         classes=jnp.asarray(classes),
                         class_agnostic=False)
    got = tnms.nms_fixed(_t(boxes), _t(scores), 0.45, max_det=max_det,
                         top_k=top_k, classes=_t(classes),
                         class_agnostic=False)
    assert type(got).__name__ == "NmsResult" and got._fields == ref._fields
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)
    assert got.valid.sum() > 10
    assert tnms.MAX_WH == jnms.MAX_WH


def test_nms_fixed_one_class_is_class_agnostic():
    """With every box in class 0 the class offset moves nothing: the
    result equals the JAX package's class-agnostic `nms_fixed`."""
    boxes, scores, _ = _nms_fixed_inputs(9, 50)
    ref = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                         max_det=60, top_k=32)
    got = tnms.nms_fixed(_t(boxes), _t(scores), 0.5, max_det=60, top_k=32,
                         classes=torch.zeros(50), class_agnostic=False)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _postprocess_inputs(seed, hw=(128, 96), num_classes=90):
    rng = np.random.default_rng(seed)
    n = len(janchors.generate_anchors(janchors.AnchorConfig(), *hw))
    logits = rng.normal(-3.0, 1.5, (n, num_classes)).astype(np.float32)
    logits[::7, 0] += 4.0                               # person candidates
    regs = rng.normal(0, 0.3, (n, 4)).astype(np.float32)
    return logits, regs


@pytest.mark.parametrize("score_threshold", [0.0, 0.3])
def test_postprocess_prescored_matches_jax(score_threshold):
    """The canonical all-class postprocess of one image: decode, clip,
    class-wise `nms_fixed` over the top 128, 1-based classes. Scores and
    classes exact, boxes to 1e-4 (exp() may differ by an ulp between XLA
    and ATen, as in test_decode_boxes_matches)."""
    from human_body_proportion_estimation_tpu.models import (
        efficientdet as jedet,
    )
    from human_body_proportion_estimation_tpu_torch.models import (
        efficientdet as tedet,
    )

    hw = (128, 96)
    logits, regs = _postprocess_inputs(1, hw)
    best, cls = logits.max(-1), logits.argmax(-1)
    ref = jedet.postprocess_prescored(
        jnp.asarray(best), jnp.asarray(cls), jnp.asarray(regs), hw,
        score_threshold=score_threshold, iou_threshold=0.5, top_k=128)
    got = tedet.postprocess_prescored(
        _t(best), _t(cls), _t(regs), hw, score_threshold=score_threshold,
        iou_threshold=0.5, top_k=128)
    boxes, scores, classes, valid = (g.numpy() for g in got)
    np.testing.assert_array_equal(valid, np.asarray(ref[3]))
    np.testing.assert_array_equal(classes, np.asarray(ref[2]))
    np.testing.assert_array_equal(scores, np.asarray(ref[1]))
    np.testing.assert_allclose(boxes, np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-4)
    assert boxes.shape == (100, 4) and valid.sum() > 10
    assert set(classes[valid].tolist()) <= set(range(1, 91))
    assert (np.diff(scores) <= 0).all() and (classes[~valid] == 0).all()
    assert boxes[:, [0, 2]].max() <= hw[0] and boxes[:, [1, 3]].max() <= hw[1]


def test_postprocess_from_logits_matches_jax():
    """`postprocess` takes the class max and argmax of the logits (the
    lower class among equal logits) over the given anchors."""
    from human_body_proportion_estimation_tpu.models import (
        efficientdet as jedet,
    )
    from human_body_proportion_estimation_tpu_torch.models import (
        efficientdet as tedet,
    )

    hw = (128, 96)
    logits, regs = _postprocess_inputs(2, hw)
    logits[3, 5] = logits[3, 9] = logits[3].max() + 1.0      # a class tie
    ref = jedet.postprocess(jnp.asarray(logits), jnp.asarray(regs), hw,
                            top_k=128)
    anchors = _t(tanchors.generate_anchors(tanchors.AnchorConfig(), *hw))
    got = tedet.postprocess(_t(logits), _t(regs), hw, anchors, top_k=128)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4 if i == 0 else 0)
