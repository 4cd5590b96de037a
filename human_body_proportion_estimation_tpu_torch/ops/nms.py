"""Greedy NMS over fixed-size candidate sets (port of the JAX package's
`ops/nms.py`).

`nms_mask` is the plain version of the NMS sweep kernel
(`ops/kernels.nms_sweep`) and the reference the kernel is held against: a
box survives iff its score is > 0 and no earlier (higher-scoring)
surviving box overlaps it with IoU > t, where IoU is the division form of
`ops/boxes.box_iou`, or of `box_iou_plus1` (the legacy +1-pixel
convention) with `legacy_plus1_iou`.

`nms_fixed` is the static-shape greedy NMS of the detection postprocesses:
a stable descending top-K, the class-offset trick for per-class
suppression, the keep mask through `kernels.nms_sweep` (the CUDA kernel
for CUDA tensors, `nms_mask` for CPU ones), and the kept rows compacted to
the front in rank order, padded to `max_det` slots. `yolo_nms`,
`yolo_nms_scored` and `yolo_nms_legacy` are the YOLOv5 postprocesses built
on it.

Every function here takes one image ([N, ...]) as the JAX functions do, or
a batch ([B, N, ...]): a batch is swept by ONE kernel launch, and the
result has the same leading dimension.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from human_body_proportion_estimation_tpu_torch.ops.boxes import (
    box_iou,
    xywh2xyxy,
)

# class-offset constant: boxes of different classes are shifted to disjoint
# coordinate ranges so that one class-agnostic sweep suppresses per class
# (reference `modules/onnx_utils.py:141,202-204`)
MAX_WH = 4096.0


class NmsResult(NamedTuple):
    boxes: torch.Tensor    # [..., max_det, 4] xyxy
    scores: torch.Tensor   # [..., max_det]
    classes: torch.Tensor  # [..., max_det]
    valid: torch.Tensor    # [..., max_det] bool


def box_iou_plus1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the legacy +1 pixel convention of the reference's
    second NMS variant (`w_bbox_iou`, modules/onnx_utils.py:8-36): widths
    and heights counted as x2 - x1 + 1, no floor under the union.
    [..., N, 4] x [..., M, 4] -> [..., N, M], in the JAX operation order."""
    wa = (a[..., 2] - a[..., 0] + 1.0).clamp_min(0.0)
    ha = (a[..., 3] - a[..., 1] + 1.0).clamp_min(0.0)
    wb = (b[..., 2] - b[..., 0] + 1.0).clamp_min(0.0)
    hb = (b[..., 3] - b[..., 1] + 1.0).clamp_min(0.0)
    area_a, area_b = wa * ha, wb * hb
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt + 1.0).clamp_min(0.0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter
                    + 1e-16)


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    legacy_plus1_iou: bool = False,
) -> torch.Tensor:
    """Keep mask [..., K] over [..., K, 4] xyxy boxes sorted by descending
    score. Scores only gate validity (score <= 0 rows are dead padding).

    The sweep is sequential in K, as in the JAX `fori_loop`; leading
    dimensions (images) are swept together.
    """
    k = boxes.shape[-2]
    iou_fn = box_iou_plus1 if legacy_plus1_iou else box_iou
    overlapping = iou_fn(boxes, boxes) > iou_threshold    # [..., K, K]
    keep = scores > 0.0
    for i in range(1, k):
        # box i is suppressed iff a kept earlier box overlaps it
        suppressed = (keep[..., :i] & overlapping[..., :i, i]).any(-1)
        keep[..., i] &= ~suppressed
    return keep


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] rows idx [B, M] -> [B, M, ...]."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _top_k(scores: torch.Tensor, k: int):
    """The k best scores of each row and their indices, in the order of
    `jax.lax.top_k`: descending, the lower index first among equal scores
    (a stable descending sort)."""
    top, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :k].contiguous(), order[..., :k]


def _compact(keep, top_boxes, top_scores, top_classes,
             max_det: int) -> NmsResult:
    """Kept rows to the front in rank order (one sort key a row), padded
    or cut to `max_det` slots, invalid slots zeroed."""
    k = keep.shape[-1]
    rank = torch.arange(k, device=keep.device).expand_as(keep)
    perm = torch.argsort(torch.where(keep, rank, rank + k), dim=-1)
    perm = perm[..., :max_det]
    out_valid = torch.gather(keep, 1, perm)
    pad = max(0, max_det - k)
    if pad:
        perm = torch.cat([perm, perm.new_zeros((perm.shape[0], pad))], 1)
        out_valid = torch.cat(
            [out_valid, out_valid.new_zeros((perm.shape[0], pad))], 1)
    return NmsResult(
        torch.where(out_valid[..., None], _gather(top_boxes, perm), 0.0),
        torch.where(out_valid, _gather(top_scores, perm), 0.0),
        torch.where(out_valid, _gather(top_classes, perm), 0.0),
        out_valid,
    )


def _batched(fn):
    """Runs `fn` on [B, N, ...] inputs; a single image ([N, ...], the JAX
    functions' form) gets a batch of one and loses it again."""

    @functools.wraps(fn)
    def wrapper(first, *args, **kwargs):
        if first.dim() == 2:
            args = [a[None] if isinstance(a, torch.Tensor) else a
                    for a in args]
            kwargs = {k: v[None] if isinstance(v, torch.Tensor) else v
                      for k, v in kwargs.items()}
            return NmsResult(*(t[0] for t in fn(first[None], *args,
                                                 **kwargs)))
        return fn(first, *args, **kwargs)

    return wrapper


def _sweep(boxes, scores, iou_threshold, plus1=False):
    from human_body_proportion_estimation_tpu_torch.ops import kernels

    return kernels.nms_sweep(boxes.contiguous(), scores.contiguous(),
                             iou_threshold, plus1=plus1)


@_batched
def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    top_k: int = 512,
    classes: Optional[torch.Tensor] = None,
    class_agnostic: bool = True,
) -> NmsResult:
    """Greedy NMS with static shapes (the JAX signature and defaults).

    boxes [N, 4] xyxy, scores [N] (entries <= 0 are dead), classes [N]
    (optional, carried to the output); or all three with a leading batch
    dimension. The top `min(top_k, N)` candidates enter the sweep, in the
    order of a stable descending sort (the lower index first among equal
    scores, as `jax.lax.top_k`). With `class_agnostic=False` each box is
    shifted by class * MAX_WH, so boxes of different classes never
    overlap. On CUDA the sweep is the kernel, one launch for the batch,
    which takes K <= 512 candidates and raises beyond.

    Returns `max_det` slots, kept boxes first in rank order; invalid slots
    are zeroed.
    """
    if classes is None:
        classes = torch.zeros_like(scores, dtype=boxes.dtype)
    k = min(top_k, boxes.shape[-2])
    top_scores, order = _top_k(scores, k)
    top_boxes, top_classes = _gather(boxes, order), _gather(classes, order)
    nms_boxes = top_boxes
    if not class_agnostic:
        nms_boxes = top_boxes + top_classes.to(boxes.dtype)[..., None] * MAX_WH
    keep = _sweep(nms_boxes, top_scores, iou_threshold)
    return _compact(keep, top_boxes, top_scores, top_classes, max_det)


@_batched
def yolo_nms(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    top_k: int = 512,
    agnostic: bool = False,
    class_filter: Optional[int] = None,
) -> NmsResult:
    """YOLOv5 "official" postprocess, fixed-shape (reference
    `non_max_suppression`, `modules/onnx_utils.py:125-222`, best-class
    branch): conf = obj * cls; keep obj > thres and conf > thres; xywh ->
    xyxy; class-offset NMS (unless `agnostic`); cap at max_det.

    prediction: [N, 5 + nc] rows (cx, cy, w, h, obj, cls...), or
    [B, N, 5 + nc]. `class_filter`: a single class id to keep (the
    pipeline's person-only filter, reference FLAGS.classes=0).
    """
    boxes = xywh2xyxy(prediction[..., :4])
    obj = prediction[..., 4]
    cls_conf = prediction[..., 5:] * obj[..., None]
    conf, best_cls = cls_conf.amax(-1), cls_conf.argmax(-1)

    valid = (obj > conf_thres) & (conf > conf_thres)
    if class_filter is not None:
        valid &= best_cls == class_filter
    conf = torch.where(valid, conf, 0.0)
    return nms_fixed(
        boxes, conf, iou_thres, max_det, top_k,
        classes=best_cls.to(boxes.dtype), class_agnostic=agnostic)


@_batched
def yolo_nms_scored(
    boxes_xywh: torch.Tensor,
    obj: torch.Tensor,
    best_cls: torch.Tensor,
    best_logit: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    top_k: int = 512,
    agnostic: bool = False,
    class_filter: Optional[int] = None,
) -> NmsResult:
    """`yolo_nms` from the pre-reduced representation of
    `models.yolov5.decode_scored` (class argmax / max taken on the logits;
    sigmoid is monotone, so the selection is the same): conf =
    sigmoid(best_logit) * obj; keep obj > thres and conf > thres; xywh ->
    xyxy; class-offset NMS; cap at max_det.

    boxes_xywh [N, 4], obj [N] (post-sigmoid), best_cls [N] int,
    best_logit [N] (pre-sigmoid); or each with a leading batch dimension.
    """
    boxes = xywh2xyxy(boxes_xywh)
    conf = torch.sigmoid(best_logit) * obj

    valid = (obj > conf_thres) & (conf > conf_thres)
    if class_filter is not None:
        valid &= best_cls == class_filter
    conf = torch.where(valid, conf, 0.0)
    return nms_fixed(
        boxes, conf, iou_thres, max_det, top_k,
        classes=best_cls.to(boxes.dtype), class_agnostic=agnostic)


@_batched
def yolo_nms_legacy(
    prediction: torch.Tensor,
    num_classes: int,
    conf_thres: float = 0.5,
    nms_thres: float = 0.4,
    max_det: int = 300,
    top_k: int = 512,
) -> NmsResult:
    """The reference's second YOLO postprocess (`w_non_max_suppression`,
    modules/onnx_utils.py:39-95): xywh -> xyxy, objectness filter, best of
    the first `num_classes` classes, per-class greedy NMS ranked by
    objectness with the +1 IoU (the sweep kernel's +1 variant on CUDA).
    Per class through the class-offset trick, which equals the per-class
    loop because offset boxes of different classes never overlap.
    """
    boxes = xywh2xyxy(prediction[..., :4])
    obj = prediction[..., 4]
    cls_conf = prediction[..., 5:5 + num_classes]
    best_cls = cls_conf.argmax(-1).to(boxes.dtype)
    scores = torch.where(obj >= conf_thres, obj, 0.0)  # ranked by obj (:76-78)

    k = min(top_k, boxes.shape[-2])
    top_scores, order = _top_k(scores, k)
    top_boxes, top_cls = _gather(boxes, order), _gather(best_cls, order)
    offset_boxes = top_boxes + top_cls[..., None] * MAX_WH
    keep = _sweep(offset_boxes, top_scores, nms_thres, plus1=True)
    return _compact(keep, top_boxes, top_scores, top_cls, max_det)
