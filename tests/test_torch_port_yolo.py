"""The port's YOLOv5 slot against the JAX package's, on the CPU: box and
image ops, the YOLO NMS family (the sweep's plain version), the YOLOv5
model and its decodes, the official-name converter, the backend, the
whole `InferencePipeline(detector="yolov5s")`, the registry's `yolov5s`,
`detect_yolo` and the flags.

The same inputs and weights, made from seeds with numpy
(tests/torch_port_yolo.py), go through both packages. Most cases use a
reduced YOLOv5 (C3 depths 1/2/3/1, widths 8-128) at 128x128; one forward
is the full-width YOLOv5m at 640x640, and the pipeline, registry and CLI
cases run the full-width YOLOv5s. Tolerances, stated per test: f32 heads
agree to ~1e-5 relative (two f32 convolution implementations), keep masks
and classes exactly, decoded boxes to 1e-3 pixels.

With random weights obj x cls ~ 0.25 never passes conf 0.4, so the Detect
objectness and person biases are raised (`seeded_state`); each test that
needs persons asserts it got some.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_body_proportion_estimation_tpu.models import yolov5 as jyolo
from human_body_proportion_estimation_tpu.ops import (
    boxes as jboxes,
    image as jimage,
    nms as jnms,
)
from human_body_proportion_estimation_tpu_torch.models import yolov5 as tyolo
from human_body_proportion_estimation_tpu_torch.models.tflite_import import (
    DEFAULT_TFLITE_PATH,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    boxes as tboxes,
    image as timage,
    kernels,
    nms as tnms,
)
from tests.test_ops_nms import legacy_wnms_oracle
from tests.torch_port_nms_cases import nms_cases
from tests.torch_port_yolo import (
    TINY,
    TINY_SIZE,
    configs,
    model_inputs,
    port_model,
    seeded,
    to_flax,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------- #
# ops/boxes


def test_xywh2xyxy_exact():
    b = np.random.default_rng(0).uniform(0, 300, (2, 50, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(tboxes.xywh2xyxy(_t(b)).numpy(),
                                  _np(jboxes.xywh2xyxy(jnp.asarray(b))))


@pytest.mark.parametrize("model_hw,orig_hw", [
    ((640, 640), (480, 640)), ((640, 640), (300, 500)),
    ((640, 640), (900, 700)), ((128, 128), (128, 128)),
])
def test_scale_coords_letterbox_matches(model_hw, orig_hw):
    """Exact but for one f32 rounding of the division (1e-4 px)."""
    b = np.random.default_rng(1).uniform(-20, 660, (40, 4)).astype(
        np.float32)
    got = tboxes.scale_coords_letterbox(_t(b), model_hw, orig_hw).numpy()
    ref = _np(jboxes.scale_coords_letterbox(jnp.asarray(b), model_hw,
                                            orig_hw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (got >= 0).all() and (got[:, 2] <= orig_hw[1]).all()


# --------------------------------------------------------------------- #
# ops/image


@pytest.mark.parametrize("hw,size", [((400, 500), 320), ((100, 120), 640),
                                     ((300, 500), 640), ((13, 17), 64)],
                         ids=["down", "up", "up_wide", "up_odd"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_letterbox_matches_jax(hw, size, dtype):
    """A geometry that really resizes. f32: within 2e-3 of JAX on [0,255]
    and within 2e-4 of a float64 evaluation of the same resampling (the
    JAX CPU product itself is ~1.4e-3 from it); uint8: the same values but
    where the two land on either side of a rounding boundary (+-1)."""
    img = np.random.default_rng(2).integers(0, 256, (1, *hw, 3)).astype(
        dtype)
    got = timage.letterbox(_t(img), size, size).numpy()
    ref = _np(jimage.letterbox(jnp.asarray(img), size, size))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    if dtype == np.uint8:
        assert d.max() <= 1 and d.mean() < 1e-3
        return
    assert d.max() <= 2e-3
    scale = min(size / hw[1], size / hw[0])
    nh, nw = int(hw[0] * scale), int(hw[1] * scale)
    exact = np.einsum("bhwc,hk->bkwc", img.astype(np.float64),
                      timage.weight_matrix(hw[0], nh, "cubic", True))
    exact = np.einsum("bkwc,wl->bklc", exact,
                      timage.weight_matrix(hw[1], nw, "cubic", True))
    top, left = (size - nh) // 2, (size - nw) // 2
    np.testing.assert_allclose(got[:, top:top + nh, left:left + nw], exact,
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_letterbox_480x640_is_pure_padding(dtype):
    """The serving geometry: scale 1.0, no resampling at all, 80 gray rows
    above and below; equal to JAX bit for bit."""
    img = np.random.default_rng(3).integers(0, 256, (2, 480, 640, 3)).astype(
        dtype)
    got = timage.letterbox(_t(img), 640, 640).numpy()
    np.testing.assert_array_equal(
        got, _np(jimage.letterbox(jnp.asarray(img), 640, 640)))
    np.testing.assert_array_equal(got[:, 80:560], img)
    assert (got[:, :80] == 128).all() and (got[:, 560:] == 128).all()


def test_letterbox_close_to_pil_and_host_letterbox_matches():
    """As JAX tests/test_ops_image.py:28 holds its op to the reference's
    PIL letterbox; and the port's `letterbox_host` (PIL bicubic) equals
    the JAX one exactly."""
    from human_body_proportion_estimation_tpu.pipeline import detect as jdet
    from human_body_proportion_estimation_tpu_torch.pipeline import (
        detect as tdet,
    )

    img = np.random.default_rng(4).integers(0, 256, (300, 500, 3),
                                            dtype=np.uint8)
    host = tdet.letterbox_host(img, 640)
    np.testing.assert_array_equal(host, jdet.letterbox_host(img, 640))
    got = timage.letterbox(_t(img), 640, 640).numpy().astype(np.int32)
    expect = np.rint(host * 255.0).astype(np.int32)
    assert np.all(got[:2] == 128) and np.all(got[-2:] == 128)
    assert np.mean(np.abs(got - expect)) < 2.0


@pytest.mark.parametrize("shape", [(240, 320, 480, 640), (480, 640, 300, 300),
                                   (100, 80, 37, 91)],
                         ids=["up", "down", "mixed"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_bilinear_matches_jax(shape, dtype):
    """Half-pixel bilinear, no antialias. f32 within 5e-4 on [0,255];
    uint8 +-1 at rounding boundaries."""
    h, w, oh, ow = shape
    img = np.random.default_rng(5).integers(0, 256, (h, w, 3)).astype(dtype)
    got = timage.resize_bilinear(_t(img), oh, ow).numpy()
    ref = _np(jimage.resize_bilinear(jnp.asarray(img), oh, ow))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert d.max() <= (1 if dtype == np.uint8 else 5e-4)
    assert d.mean() < 1e-3


def test_small_image_ops_match():
    assert all(timage.aspect_resize_shape(*a) == jimage.aspect_resize_shape(*a)
               for a in [(480, 640, 640, 480), (400, 600, None, 200),
                         (400, 600, 300, None), (400, 600, None, None)])
    img = np.random.default_rng(6).integers(0, 256, (2, 8, 8, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(
        timage.normalize_uint8(_t(img)).numpy(),
        _np(jimage.normalize_uint8(jnp.asarray(img))))
    np.testing.assert_array_equal(timage.bgr_to_rgb(_t(img)).numpy(),
                                  _np(jimage.bgr_to_rgb(jnp.asarray(img))))
    np.testing.assert_array_equal(timage.hwc_to_chw(_t(img)).numpy(),
                                  _np(jimage.hwc_to_chw(jnp.asarray(img))))


# --------------------------------------------------------------------- #
# ops/nms: the +1 IoU and the YOLO postprocesses


def test_box_iou_plus1_exact():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 200, (60, 2))
    b = np.concatenate([xy, xy + rng.uniform(-5, 80, (60, 2))], -1).astype(
        np.float32)
    np.testing.assert_array_equal(
        tnms.box_iou_plus1(_t(b), _t(b)).numpy(),
        _np(jnms.box_iou_plus1(jnp.asarray(b), jnp.asarray(b))))


_CASES = nms_cases()


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_nms_mask_plus1_on_the_shared_cases_matches_jax(case):
    """The +1 variant of the plain sweep (the kernel's plain version with
    `plus1=True`) on every shared case, image by image against JAX
    `nms_mask(..., legacy_plus1_iou=True)`: exact."""
    _, boxes, scores, t, _ = case
    got = kernels.nms_sweep(_t(boxes), _t(scores), t, plus1=True).numpy()
    for i in range(boxes.shape[0]):
        ref = _np(jnms.nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                t, legacy_plus1_iou=True))
        np.testing.assert_array_equal(got[i], ref)


def _predictions(seed, n=900, nc=6, b=None):
    """YOLO prediction rows [.., n, 5 + nc]: clustered boxes, objectness
    and class scores spread over the 0.25 / 0.45 thresholds."""
    rng = np.random.default_rng(seed)
    shape = (n,) if b is None else (b, n)
    centers = rng.uniform(40, 600, (25, 2))
    xy = centers[rng.integers(0, 25, shape)] + rng.normal(0, 8, (*shape, 2))
    wh = rng.uniform(10, 90, (*shape, 2))
    obj = rng.uniform(0, 1, shape)
    cls = rng.uniform(0, 1, (*shape, nc))
    return np.concatenate([xy, wh, obj[..., None], cls], -1).astype(
        np.float32)


@pytest.mark.parametrize("top_k", [128, 512])
@pytest.mark.parametrize("agnostic", [False, True])
def test_yolo_nms_matches_jax(top_k, agnostic):
    """Exact: candidates, top-k order, class offset, keep mask,
    compaction."""
    pred = _predictions(10)
    ref = jnms.yolo_nms(jnp.asarray(pred), 0.25, 0.45, 600, top_k,
                        agnostic=agnostic)
    got = tnms.yolo_nms(_t(pred), 0.25, 0.45, 600, top_k, agnostic=agnostic)
    assert got._fields == ref._fields
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_array_equal(g.numpy(), _np(r), name)
    assert 20 < int(got.valid.sum()) < top_k


@pytest.mark.parametrize("top_k", [128, 512])
@pytest.mark.parametrize("agnostic", [False, True])
def test_yolo_nms_scored_matches_jax(top_k, agnostic):
    """From the logits: conf = sigmoid(best_logit) * obj. Boxes, classes
    and the mask exact, scores to 1 ulp (sigmoid in two libraries)."""
    rng = np.random.default_rng(11)
    pred = _predictions(11)
    logit = rng.normal(0, 2, 900).astype(np.float32)
    cls = rng.integers(0, 6, 900).astype(np.int32)
    args = (pred[:, :4], pred[:, 4], cls, logit)
    ref = jnms.yolo_nms_scored(*map(jnp.asarray, args), 0.25, 0.45, 300,
                               top_k, agnostic=agnostic, class_filter=None)
    got = tnms.yolo_nms_scored(*map(_t, args), 0.25, 0.45, 300, top_k,
                               agnostic=agnostic)
    for name in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), name)
    np.testing.assert_allclose(got.scores.numpy(), _np(ref.scores),
                               rtol=2e-7, atol=0)
    assert int(got.valid.sum()) > 20


@pytest.mark.parametrize("top_k", [128, 512])
def test_yolo_nms_legacy_matches_jax_and_the_greedy_oracle(top_k):
    """The +1-IoU per-class sweep ranked by objectness: exact against JAX,
    and the kept objectness scores equal the reference w-NMS oracle's
    (JAX tests/test_ops_nms.py:111) when every candidate fits in top_k."""
    pred = _predictions(12, n=400, nc=4)
    ref = jnms.yolo_nms_legacy(jnp.asarray(pred), 4, 0.5, 0.4, 300, top_k)
    got = tnms.yolo_nms_legacy(_t(pred), 4, 0.5, 0.4, 300, top_k)
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_array_equal(g.numpy(), _np(r), name)
    n_live = int((pred[:, 4] >= 0.5).sum())
    assert int(got.valid.sum()) > 10
    if n_live <= top_k:
        rows = legacy_wnms_oracle(pred, 4, 0.5, 0.4)
        np.testing.assert_allclose(
            np.sort(got.scores.numpy()[got.valid.numpy()])[::-1],
            np.sort(pred[list(rows), 4])[::-1], rtol=1e-6)


def test_yolo_nms_official_matches_a_greedy_oracle():
    """`yolo_nms` against a per-class greedy loop in numpy (the reference
    `non_max_suppression` best-class branch), every candidate in top_k."""
    pred = _predictions(13, n=300, nc=3)
    res = tnms.yolo_nms(_t(pred), 0.45, 0.45, 300, 512)
    boxes = _np(jboxes.xywh2xyxy(jnp.asarray(pred[:, :4])))
    conf_all = pred[:, 5:] * pred[:, 4:5]
    cls, conf = conf_all.argmax(-1), conf_all.max(-1)
    live = (pred[:, 4] > 0.45) & (conf > 0.45)
    kept = []
    for c in np.unique(cls[live]):
        rows = np.where(live & (cls == c))[0]
        rows = rows[np.argsort(-conf[rows], kind="stable")]
        while len(rows):
            best, rows = rows[0], rows[1:]
            kept.append(best)
            a, b = boxes[best], boxes[rows]
            iw = np.maximum(np.minimum(a[2], b[:, 2])
                            - np.maximum(a[0], b[:, 0]), 0)
            ih = np.maximum(np.minimum(a[3], b[:, 3])
                            - np.maximum(a[1], b[:, 1]), 0)
            inter = iw * ih
            iou = inter / ((a[2] - a[0]) * (a[3] - a[1])
                           + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                           - inter)
            rows = rows[iou <= 0.45]
    np.testing.assert_allclose(
        np.sort(res.scores.numpy()[res.valid.numpy()]),
        np.sort(conf[kept]), rtol=1e-6)


@pytest.mark.parametrize("fn", ["yolo_nms", "yolo_nms_legacy"])
def test_batched_yolo_nms_equals_image_by_image(fn):
    """[B, N, 85] is swept in one call (one kernel launch on CUDA) and
    equals the images one at a time."""
    pred = _predictions(14, n=300, b=3)
    call = (lambda p: tnms.yolo_nms(p, 0.3, 0.45, 100, 512)) \
        if fn == "yolo_nms" else \
        (lambda p: tnms.yolo_nms_legacy(p, 6, 0.5, 0.4, 100, 512))
    kernels.reset_launch_counts()
    batched = call(_t(pred))
    for i in range(3):
        single = call(_t(pred[i]))
        for g, r in zip(batched, single):
            np.testing.assert_array_equal(g[i].numpy(), r.numpy())
    assert kernels.launch_counts()["nms_sweep"] == 0   # CPU: plain version


def test_nms_fixed_signature_and_defaults_match_jax():
    """The JAX signature and defaults (iou 0.45, max_det 300, top_k 512,
    classes None, class_agnostic True), and both called with defaults
    agree."""
    def params(f):
        return [(p.name, p.default) for p in
                inspect.signature(f).parameters.values()]

    assert params(tnms.nms_fixed) == params(jnms.nms_fixed)
    rng = np.random.default_rng(15)
    xy = rng.uniform(0, 400, (700, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (700, 2))],
                           -1).astype(np.float32)
    scores = rng.uniform(0, 1, 700).astype(np.float32)
    got = tnms.nms_fixed(_t(boxes), _t(scores))
    ref = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores))
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_array_equal(g.numpy(), _np(r), name)
    assert got.boxes.shape == (300, 4) and int(got.valid.sum()) > 50


def test_nms_sweep_takes_512_candidates_on_the_cpu():
    """K = 512, both IoU forms: the plain version equals JAX `nms_mask`."""
    rng = np.random.default_rng(16)
    xy = rng.uniform(0, 600, (512, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 90, (512, 2))],
                           -1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, 512).astype(np.float32))[::-1].copy()
    for plus1 in (False, True):
        got = kernels.nms_sweep(_t(boxes[None]), _t(scores[None]), 0.5,
                                plus1=plus1).numpy()[0]
        ref = _np(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                legacy_plus1_iou=plus1))
        np.testing.assert_array_equal(got, ref)
        assert 50 < got.sum() < 500


# --------------------------------------------------------------------- #
# models/yolov5 and models/yolo_weights


@pytest.fixture(scope="module")
def tiny():
    """The reduced YOLOv5 on both sides, on calibrated seeded weights."""
    jcfg, tcfg = configs(**TINY)
    rng = np.random.default_rng(20)
    images = rng.integers(0, 256, (2, TINY_SIZE, TINY_SIZE, 3),
                          dtype=np.uint8)
    x = model_inputs(images, TINY_SIZE)
    state = seeded(tcfg, 20, x)
    return dict(jcfg=jcfg, tcfg=tcfg, state=state, images=images, x=x,
                flax=to_flax(state))


def _heads(cfg_pair, state, flax_vars, x, dtype):
    jcfg, tcfg = cfg_pair
    jm = jyolo.YoloV5(config=jcfg, dtype=jnp.float32 if dtype == torch.float32
                      else jnp.bfloat16)
    ref = jm.apply(flax_vars, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    with torch.inference_mode():
        got = port_model(tcfg, state, dtype)(_t(x))
    return [h.numpy() for h in got], [_np(h) for h in ref]


def test_yolov5_heads_f32(tiny):
    """f32: every head to 1e-4 relative to the head's largest value."""
    got, ref = _heads((tiny["jcfg"], tiny["tcfg"]), tiny["state"],
                      tiny["flax"], tiny["x"], torch.float32)
    assert [g.shape for g in got] == [r.shape for r in ref] == [
        (2, 16, 16, 255), (2, 8, 8, 255), (2, 4, 4, 255)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_yolov5_heads_bf16(tiny):
    """bf16 trunk, f32 Detect convs, as the JAX model. The seeded network
    is calibrated to the edge of chaos, where each stack's bf16 roundings
    grow on the way to the heads, so the port's bf16 heads are held to the
    JAX bf16 heads relative to the bf16 noise itself: their mean distance
    is at most twice the mean distance of the JAX bf16 heads from the JAX
    f32 heads, level by level."""
    pair = (tiny["jcfg"], tiny["tcfg"])
    got, ref = _heads(pair, tiny["state"], tiny["flax"], tiny["x"],
                      torch.bfloat16)
    _, ref32 = _heads(pair, tiny["state"], tiny["flax"], tiny["x"],
                      torch.float32)
    for g, r, r32 in zip(got, ref, ref32):
        assert g.dtype == np.float32
        noise = np.abs(r - r32).mean()
        assert 0 < np.abs(g - r).mean() <= 2 * noise, (
            np.abs(g - r).mean(), noise)


def test_decodes_match_jax(tiny):
    """decode_predictions and decode_scored on the same heads: boxes to
    1e-3 px, sigmoids to 1e-6, classes exact."""
    x = np.random.default_rng(21).normal(0, 2, (2, 16, 16, 255)).astype(
        np.float32)
    heads = [x, x[:, :8, :8].copy(), x[:, :4, :4].copy()]
    got = tyolo.decode_predictions([_t(h) for h in heads]).numpy()
    ref = _np(jyolo.decode_predictions([jnp.asarray(h) for h in heads]))
    assert got.shape == ref.shape == (2, 3 * (256 + 64 + 16), 85)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=0, atol=1e-6)
    got = tyolo.decode_scored([_t(h) for h in heads])
    ref = jyolo.decode_scored([jnp.asarray(h) for h in heads])
    np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), _np(ref[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), _np(ref[2]))
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[3].numpy(), _np(ref[3]))


def test_yolov5m_full_width_forward_at_640():
    """The full-width YOLOv5m on one 640x640 image, f32 both sides: the
    heads to 1e-4 of each head's largest value."""
    jcfg, tcfg = jyolo.YOLOV5M, tyolo.YOLOV5M
    img = np.random.default_rng(22).integers(0, 256, (1, 480, 640, 3),
                                             dtype=np.uint8)
    x = model_inputs(img, 640)
    state = seeded(tcfg, 22, x)
    got, ref = _heads((jcfg, tcfg), state, to_flax(state), x, torch.float32)
    assert [g.shape for g in got] == [(1, 80, 80, 255), (1, 40, 40, 255),
                                      (1, 20, 20, 255)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_official_names_round_trip_and_torch_reference_forward(tiny):
    """import(export(state)) is the identity; the official names load
    into tests/torch_refs.TorchYoloV5 (ultralytics v6.0 layout), whose
    forward equals the port's (f32, 1e-5 relative); the JAX converter
    gives the flax tree of the same weights."""
    from human_body_proportion_estimation_tpu.models.yolo_weights import (
        import_torch_yolov5 as jimport,
    )
    from human_body_proportion_estimation_tpu_torch.models.yolo_weights import (  # noqa: E501
        export_torch_yolov5,
        import_torch_yolov5,
    )
    from tests.torch_refs import TorchYoloV5

    cfg, state = tiny["tcfg"], tiny["state"]
    official = export_torch_yolov5(state, cfg)
    assert "model.0.conv.weight" in official and "model.24.m.2.bias" in official
    back = import_torch_yolov5(official, cfg)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k], k)

    ref = TorchYoloV5(depth=TINY["depth_mult"], width=TINY["width_mult"])
    missing = ref.load_state_dict(
        {k: torch.from_numpy(v) for k, v in official.items()}, strict=False)
    assert not missing.unexpected_keys
    assert all(k.endswith("num_batches_tracked")
               for k in missing.missing_keys)
    ref.eval()
    x = _t(tiny["x"])
    with torch.inference_mode():
        want = ref(x)
        got = port_model(cfg, state)(x)
    for g, w in zip(got, want):
        w = w.permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))

    blank = jax.tree.map(np.zeros_like, tiny["flax"])
    jax.tree.map(np.testing.assert_array_equal,
                 jimport(official, blank, tiny["jcfg"]), tiny["flax"])


def test_import_refuses_a_missing_official_key(tiny):
    from human_body_proportion_estimation_tpu_torch.models.yolo_weights import (  # noqa: E501
        export_torch_yolov5,
        import_torch_yolov5,
    )

    official = export_torch_yolov5(tiny["state"], tiny["tcfg"])
    del official["model.9.cv1.conv.weight"]
    with pytest.raises(KeyError):
        import_torch_yolov5(official, tiny["tcfg"])
    partial = import_torch_yolov5(official, tiny["tcfg"], strict=False)
    assert "sppf.cv1.conv.weight" not in partial and "sppf.cv1.bn.weight" \
        in partial


def test_seeded_state_is_reproducible_and_gives_persons(tiny):
    """The same seed and images give the same numbers; the shaped biases
    put person candidates above conf 0.4 on the images it was
    calibrated on."""
    again = seeded(tiny["tcfg"], 20, tiny["x"])
    for k, v in tiny["state"].items():
        np.testing.assert_array_equal(again[k], v, k)
    with torch.inference_mode():
        heads = port_model(tiny["tcfg"], tiny["state"])(_t(tiny["x"]))
        res = tnms.yolo_nms_scored(*tyolo.decode_scored(heads), 0.4, 0.5,
                                   100, 128, class_filter=0)
    assert (res.valid.sum(-1) > 0).all()


# --------------------------------------------------------------------- #
# pipeline/backends.YoloBackend and the whole InferencePipeline


def _tiny_pose():
    """The tiny HRNet of the EfficientDet pipeline tests, both sides."""
    from human_body_proportion_estimation_tpu.models.hrnet import (
        HRNet as JHRNet,
    )
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
    )
    from tests.test_torch_port_models import (
        _port_hrnet_config,
        _randomize_bn,
    )
    from tests.tiny_models import tiny_w32_config
    from tests.torch_port_tiny import CROP_HW, _filled

    jpose_cfg = tiny_w32_config()
    jpose = JHRNet(config=jpose_cfg, dtype=jnp.float32)
    pose_vars = _randomize_bn(_filled(jpose, CROP_HW, 1), 11)
    return (jpose, pose_vars, flax_to_state_dict(pose_vars),
            _port_hrnet_config(jpose_cfg))


def _det_batch(images, tcfg):
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        resize_for_detector,
    )

    h, w = tcfg.detector.input_height, tcfg.detector.input_width
    return np.stack([resize_for_detector(i, w, h) for i in images])


def _pipeline_images():
    rng = np.random.default_rng(30)
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in [(150, 100, 3), (128, 128, 3), (90, 200, 3)]]


def test_yolo_backend_person_slots_match_jax(tiny):
    """The tiny YOLOv5 at 128x128 behind each package's YoloBackend, f32:
    person slots (validity and scores exact to 1e-5, boxes to 1e-3 px);
    the port sweeps the batch in one call."""
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        YoloBackend as JBackend,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.backends import (
        YoloBackend as TBackend,
    )
    from tests.torch_port_tiny import configs as pipeline_configs

    jcfg, tcfg = pipeline_configs()
    jb = JBackend(jcfg, "yolov5s", input_size=TINY_SIZE)
    jb.model = jyolo.YoloV5(config=tiny["jcfg"], dtype=jnp.float32)
    tb = TBackend(port_model(tiny["tcfg"], tiny["state"]), tcfg,
                  input_size=TINY_SIZE)
    images = tiny["images"].astype(np.float32)
    thres = np.array([0.45, 0.6], np.float32)
    with torch.inference_mode():
        got = tb(_t(images), _t(thres))
    for i in range(2):
        ref = jb(tiny["flax"], jnp.asarray(images[i]), jnp.float32(thres[i]))
        np.testing.assert_array_equal(got[2][i].numpy(), _np(ref[2]))
        np.testing.assert_allclose(got[1][i].numpy(), _np(ref[1]), atol=1e-5)
        np.testing.assert_allclose(got[0][i].numpy(), _np(ref[0]), atol=1e-3)
    assert got[2].sum() >= 2, "the shaped biases must yield persons"


@pytest.fixture(scope="module")
def yolov5s_pipelines():
    """`InferencePipeline(detector="yolov5s")` of both packages at the tiny
    pipeline shapes (128x128 det input, letterboxed to the YOLO's 640)
    with the full-width YOLOv5s and the tiny HRNet, f32, on the same
    seeded weights."""
    from human_body_proportion_estimation_tpu.pipeline.backends import (
        YoloBackend as JBackend,
    )
    from human_body_proportion_estimation_tpu.pipeline.host import (
        InferencePipeline as JPipeline,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline as TPipeline,
    )
    from tests.torch_port_tiny import configs as pipeline_configs

    jcfg, tcfg = pipeline_configs()
    jpose, pose_vars, pose_state, pose_cfg = _tiny_pose()
    x = model_inputs(_det_batch(_pipeline_images(), tcfg), 640)
    state = seeded(tyolo.YOLOV5S, 31, x)
    jb = JBackend(jcfg, "yolov5s")
    jb.model = jyolo.YoloV5(config=jyolo.YOLOV5S, dtype=jnp.float32)
    jpipe = JPipeline(config=jcfg, backend=jb, pose=jpose,
                      det_vars=to_flax(state), pose_vars=pose_vars)
    tpipe = TPipeline(tcfg, {k: torch.from_numpy(v) for k, v in
                             state.items()}, pose_state, device="cpu",
                      pose_config=pose_cfg, dtype=torch.float32,
                      detector="yolov5s")
    return jpipe, tpipe, state


def test_pipeline_yolov5s_matches_jax(yolov5s_pipelines):
    """The whole slice: person validity exact, scores and boxes to 1e-3,
    the packed [B, 3, 23] serving output on the decisive segments
    (tests/test_torch_port_pipeline.py's rule: off the far image edges,
    top-two heatmap gap > 1e-3) to 1e-3 cm."""
    from tests.test_torch_port_pipeline import _decisive

    jpipe, tpipe, _ = yolov5s_pipelines
    images, heights = _pipeline_images(), [[170.0], [180.0, 160.0], [175.0]]
    ref = jpipe.infer_images(images, heights, det_threshold=0.45,
                             with_heatmaps=True)
    got = tpipe.infer_images(images, heights, det_threshold=0.45,
                             with_heatmaps=True)
    valid = np.asarray(ref.person_valid)
    assert valid.sum() >= 3, "the shaped biases must yield persons"
    np.testing.assert_array_equal(got.person_valid, valid)
    for name in ("det_scores", "boxes_norm", "boxes_orig"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    _, seg_ok = _decisive(ref)
    assert seg_ok[valid].sum() >= 5
    packed_ref = np.asarray(jpipe.infer_serving(images, heights, 0.45))
    packed = tpipe.infer_serving(images, heights, 0.45)
    assert packed.shape == packed_ref.shape == (3, 3, 23)
    np.testing.assert_array_equal(packed[..., 0], packed_ref[..., 0])
    np.testing.assert_array_equal(packed[..., 12:][seg_ok],
                                  packed_ref[..., 12:][seg_ok])
    np.testing.assert_allclose(packed[..., 1:12][seg_ok],
                               packed_ref[..., 1:12][seg_ok],
                               rtol=1e-3, atol=1e-3)


def test_pipeline_yolo_random_detector_is_labelled_and_prewarms(capfd):
    """Without det_state the YOLO detector is drawn from a seeded
    torch.Generator: the same numbers every time, "random" in
    weights_origin with the JAX package's warning, and the serving
    forward runs at every batch bucket. The SSD slot with its tflite
    absent raises the JAX package's error naming the file."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
        prewarm_serving,
    )
    from tests.torch_port_tiny import configs as pipeline_configs

    _, tcfg = pipeline_configs()
    _, _, pose_state, pose_cfg = _tiny_pose()
    pipes = [InferencePipeline(tcfg, None, pose_state, device="cpu",
                               pose_config=pose_cfg, dtype=torch.float32,
                               detector="yolov5s") for _ in range(2)]
    a, b = (p.backend.model.state_dict() for p in pipes)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert pipes[0].weights_origin == {"detector": "random", "pose": "real"}
    assert "RANDOM-INIT WEIGHTS IN USE" in capfd.readouterr().err
    assert prewarm_serving(pipes[0]) == [1, 2, 4] and pipes[0].prewarmed
    # the SSD slot without the reference's ssd.tflite (absent here): the
    # JAX package's error, naming the file; never random weights
    with pytest.raises(ValueError, match="Could not open .*ssd.tflite"):
        InferencePipeline(tcfg, None, pose_state, device="cpu",
                          pose_config=pose_cfg, detector="ssd_mobilenet")


def test_pipeline_yolov5m_default_pairs_the_certified_pose():
    """`InferencePipeline(detector="yolov5m")` with nothing passed: the
    YOLOv5m at random before the committed certified HRNet-W32, as the
    JAX server pairs them."""
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )

    pipe = InferencePipeline(device="cpu", detector="yolov5m")
    assert pipe.weights_origin == {"detector": "random",
                                   "pose": "synthetic-certified"}
    assert pipe.backend.model.config == tyolo.YOLOV5M
    assert pipe.backend.model.dtype == torch.bfloat16


# --------------------------------------------------------------------- #
# serve/registry: yolov5s


def test_registry_yolov5s_matches_jax(yolov5s_pipelines):
    """The registry's `yolov5s` on the serving pipeline's detector, both
    packages: the documents (`platform` apart) and the [n, 25200, 85]
    answer, f32: boxes to 2e-3 px + 1e-3 relative (widths reach ~1500
    px), probabilities to 1e-4."""
    import types

    from human_body_proportion_estimation_tpu.serve.registry import (
        build_registry as jbuild,
    )
    from human_body_proportion_estimation_tpu_torch.serve.registry import (
        build_registry as tbuild,
    )

    jpipe, tpipe, _ = yolov5s_pipelines
    stand_in = types.SimpleNamespace(
        config=jpipe.config, weights_origin={"detector": "real",
                                             "pose": "real"},
        pose=jpipe.pose, pose_vars=jpipe.pose_vars, det_vars=jpipe.det_vars,
        mesh=None, backend=jpipe.backend)
    jreg = jbuild(stand_in, include=("yolov5s", "yolov5m"))
    treg = tbuild(tpipe)
    for name in ("yolov5s", "yolov5m"):
        for doc in ("metadata", "config"):
            ref, got = getattr(jreg, doc)(name), getattr(treg, doc)(name)
            assert got.pop("platform") == "pytorch"
            ref.pop("platform")
            assert got == ref, (name, doc)
    assert [r["weights"] for r in treg.index() if r["name"] == "yolov5s"] \
        == ["real"]
    x = model_inputs(_det_batch(_pipeline_images()[:2], tpipe.config), 640)
    ref = jreg.infer("yolov5s", {"images": x})["output"]
    got = treg.infer("yolov5s", {"images": x})["output"]
    assert got.shape == ref.shape == (2, 25200, 85)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], rtol=0, atol=1e-4)
    jreg.shutdown()
    treg.shutdown()


# --------------------------------------------------------------------- #
# cli/detect_yolo, the flags


@pytest.fixture(scope="module")
def demo_image(tmp_path_factory):
    from PIL import Image

    from human_body_proportion_estimation_tpu_torch.pipeline.detect import (
        letterbox_host,
    )

    img = np.random.default_rng(40).integers(0, 256, (300, 420, 3),
                                             dtype=np.uint8)
    img[60:240, 100:200] = [200, 60, 40]     # a block a random net sees
    path = tmp_path_factory.mktemp("yolo") / "frame.png"
    Image.fromarray(img).save(path)
    x = np.transpose(letterbox_host(img)[None], (0, 3, 1, 2))
    state = seeded(tyolo.YOLOV5S, 41, x, obj_bias=-3.5)   # ~30 detections
    return str(path), state


def _with_weights(monkeypatch, state):
    """Both CLIs' random initializations replaced by the given weights."""
    flax_vars = to_flax(state)
    monkeypatch.setattr(jyolo.YoloV5, "init",
                        lambda self, *a, **k: flax_vars)

    def load(model):
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        return model

    monkeypatch.setattr(tyolo, "init_random", load)


@pytest.mark.parametrize("legacy", [False, True], ids=["official", "legacy"])
def test_detect_yolo_in_process_matches_jax_run_demo_odet(
        monkeypatch, demo_image, legacy):
    """`run_demo_odet(use_cpu=True)` of both packages on one image, f32,
    the same YOLOv5s weights: 512 candidates into the official NMS, or the
    legacy +1-IoU one; the detections (boxes in the original image to
    1e-2 px, scores to 1e-4, classes exact)."""
    from human_body_proportion_estimation_tpu.cli import detect_yolo as jcli
    from human_body_proportion_estimation_tpu_torch.cli import (
        detect_yolo as tcli,
    )

    path, state = demo_image
    _with_weights(monkeypatch, state)
    kw = dict(model_name="yolov5s", use_cpu=True, debug=False,
              legacy_nms=legacy, det_threshold=0.4 if not legacy else 0.5)
    (ref,) = jcli.run_demo_odet(path, **kw)
    (got,) = tcli.run_demo_odet(path, **kw)
    assert 0 < len(got[0]) == len(ref[0])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])


def test_detect_yolo_remote_mode_equals_in_process(monkeypatch, demo_image):
    """`-g`: the port's gRPC edge serves `yolov5s` (the serving pipeline's
    detector) and the client-side NMS gives the in-process detections."""
    pytest.importorskip("grpc")
    from human_body_proportion_estimation_tpu_torch.cli import (
        detect_yolo as tcli,
    )
    from human_body_proportion_estimation_tpu_torch.pipeline.host import (
        InferencePipeline,
    )
    from human_body_proportion_estimation_tpu_torch.serve.grpc_server import (
        create_grpc_server,
    )
    from human_body_proportion_estimation_tpu_torch.serve.server import (
        ServingApp,
    )
    from tests.torch_port_tiny import configs as pipeline_configs

    path, state = demo_image
    _with_weights(monkeypatch, state)
    _, tcfg = pipeline_configs()
    _, _, pose_state, pose_cfg = _tiny_pose()
    pipe = InferencePipeline(tcfg, {k: torch.from_numpy(v) for k, v in
                                    state.items()}, pose_state, device="cpu",
                             pose_config=pose_cfg, dtype=torch.float32,
                             detector="yolov5s")
    app = ServingApp(pipe)
    server, port = create_grpc_server(app, "127.0.0.1", 0)
    server.start()
    try:
        (remote,) = tcli.run_demo_odet(path, model_name="yolov5s",
                                       use_cpu=True, debug=False,
                                       grpc_target=str(port))
    finally:
        server.stop(0)
        app.shutdown()
    (local,) = tcli.run_demo_odet(path, model_name="yolov5s", use_cpu=True,
                                  debug=False)
    assert len(local[0]) > 0
    for r, loc in zip(remote, local):
        np.testing.assert_array_equal(r, loc)


def _detector_action(parser):
    (action,) = [a for a in parser._actions if "--detector" in
                 a.option_strings]
    return action.default, tuple(action.choices)


def test_flags_match_jax(monkeypatch):
    """The server's --detector default and choices equal the JAX server's
    (whose parser lives inside its `main`); the CLI parser's too; the
    COCO names and the per-class colors are the JAX package's."""
    import argparse

    from human_body_proportion_estimation_tpu.cli import args as jargs
    from human_body_proportion_estimation_tpu.serve import server as jserver
    from human_body_proportion_estimation_tpu.utils import draw as jdraw
    from human_body_proportion_estimation_tpu_torch.cli import args as targs
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as tserver,
    )
    from human_body_proportion_estimation_tpu_torch.utils import (
        draw as tdraw,
    )

    class Grab(Exception):
        pass

    def grab(self, *a, **k):
        raise Grab(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Grab) as caught:
            jserver.main([])
    jparser = caught.value.args[0]
    assert _detector_action(tserver.build_parser()) == \
        _detector_action(jparser) == ("ssd_mobilenet", (
            "efficientdet_lite4", "efficientdet_lite0", "ssd_mobilenet",
            "yolov5s", "yolov5m"))
    assert _detector_action(targs.build_parser("x")) == \
        _detector_action(jargs.build_parser("x"))
    assert list(targs.COCO_CLASSES) == list(jargs.COCO_CLASSES)
    assert [tdraw.class_color(c) for c in range(80)] == [
        jdraw.class_color(c) for c in range(80)]


@pytest.mark.parametrize("argv,item", [
    ([], DEFAULT_TFLITE_PATH),
    (["--detector", "ssd_mobilenet"], DEFAULT_TFLITE_PATH),
    (["--detector", "efficientdet_lite0"], None),
], ids=["default", "ssd", "lite0"])
def test_server_exits_on_detectors_not_ported(capsys, monkeypatch, argv,
                                              item):
    """The JAX default, ssd_mobilenet, exits 2 naming the reference's
    ssd.tflite, which is absent here (the JAX server fails without it,
    and the SSD is never random), before any model is built; the CLI
    helper refuses it the same way. efficientdet_lite0 (item 12): the
    server and the CLI helper build its pipeline (here on the CPU) with
    the JAX server's weights, /health "random" for the detector and
    "synthetic-certified" for the HRNet-W32."""
    import argparse

    from human_body_proportion_estimation_tpu_torch.cli import common
    from human_body_proportion_estimation_tpu_torch.cli.common import (
        build_pipeline,
    )
    from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
        EFFICIENTDET_LITE0,
    )
    from human_body_proportion_estimation_tpu_torch.serve import (
        server as tserver,
    )

    detector = argv[-1] if argv else "ssd_mobilenet"
    if item is None:
        served = []
        for module in (tserver, common):
            plain = module.InferencePipeline
            monkeypatch.setattr(
                module, "InferencePipeline",
                lambda plain=plain, **kw: plain(**{**kw, "device": "cpu"}))
        monkeypatch.setattr(tserver, "_serve",
                            lambda args, pipe: served.append(pipe))
        tserver.main(argv + ["--grpc-port", "0"])
        pipes = served + [build_pipeline(argparse.Namespace(
            detector=detector, checkpoint_dir=None))]
        for pipe in pipes:
            assert pipe.weights_origin == {"detector": "random",
                                           "pose": "synthetic-certified"}
            assert pipe.backend.detector.config == EFFICIENTDET_LITE0
        assert "synthetic-certified weights for pose" in \
            capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as exc:
        tserver.main(argv + ["--grpc-port", "0"])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        build_pipeline(argparse.Namespace(detector=detector,
                                          checkpoint_dir=None))
    assert exc.value.code == 2
    assert item in capsys.readouterr().err
