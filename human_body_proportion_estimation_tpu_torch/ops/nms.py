"""Greedy NMS over fixed-size candidate sets (port of the JAX package's
`ops/nms.nms_mask` and `ops/nms.nms_fixed`).

`nms_mask` is the plain version of the NMS sweep kernel
(`ops/kernels.nms_sweep`) and the reference the kernel is held against: a
box survives iff its score is > 0 and no earlier (higher-scoring)
surviving box overlaps it with IoU > t, where IoU is the division form of
`ops/boxes.box_iou`.

`nms_fixed` is the static-shape class-wise greedy NMS of the canonical
detection postprocess: a stable descending top-K, the class-offset trick
for per-class suppression, the keep mask through `kernels.nms_sweep` (the
CUDA kernel for CUDA tensors, `nms_mask` for CPU ones), and the kept rows
compacted to the front in rank order, padded to `max_det` slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from human_body_proportion_estimation_tpu_torch.ops.boxes import box_iou

# class-offset constant: boxes of different classes are shifted to disjoint
# coordinate ranges so that one class-agnostic sweep suppresses per class
# (reference `modules/onnx_utils.py:141,202-204`)
MAX_WH = 4096.0


class NmsResult(NamedTuple):
    boxes: torch.Tensor    # [max_det, 4] xyxy
    scores: torch.Tensor   # [max_det]
    classes: torch.Tensor  # [max_det]
    valid: torch.Tensor    # [max_det] bool


def nms_mask(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Keep mask [..., K] over [..., K, 4] xyxy boxes sorted by descending
    score. Scores only gate validity (score <= 0 rows are dead padding).

    The sweep is sequential in K, as in the JAX `fori_loop`; leading
    dimensions (images) are swept together.
    """
    k = boxes.shape[-2]
    overlapping = box_iou(boxes, boxes) > iou_threshold    # [..., K, K]
    keep = scores > 0.0
    for i in range(1, k):
        # box i is suppressed iff a kept earlier box overlaps it
        suppressed = (keep[..., :i] & overlapping[..., :i, i]).any(-1)
        keep[..., i] &= ~suppressed
    return keep


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_threshold: float = 0.5,
    max_det: int = 100,
    top_k: int = 128,
) -> NmsResult:
    """Class-wise greedy NMS of one image with static shapes.

    boxes [N, 4] xyxy, scores [N] (entries <= 0 are dead), classes [N].
    The top `min(top_k, N)` candidates enter the sweep, in the order of a
    stable descending sort (the lower index first among equal scores, as
    `jax.lax.top_k`). Each box is shifted by class * MAX_WH, so boxes of
    different classes never overlap. On CUDA the sweep is the kernel,
    which takes K <= 256 candidates and raises beyond.

    Returns `max_det` slots, kept boxes first in rank order; invalid slots
    are zeroed.
    """
    k = min(top_k, boxes.shape[0])
    top_scores, order = torch.sort(scores, descending=True, stable=True)
    top_scores, order = top_scores[:k].contiguous(), order[:k]
    top_boxes, top_classes = boxes[order], classes[order]

    nms_boxes = top_boxes + top_classes.to(boxes.dtype)[:, None] * MAX_WH
    from human_body_proportion_estimation_tpu_torch.ops import kernels

    keep = kernels.nms_sweep(nms_boxes[None].contiguous(), top_scores[None],
                             iou_threshold)[0]

    # kept rows to the front, in rank order: one sort key per row
    rank = torch.arange(k, device=boxes.device)
    perm = torch.argsort(torch.where(keep, rank, rank + k))[:max_det]
    out_valid = keep[perm]
    pad = max(0, max_det - k)
    if pad:
        perm = torch.cat([perm, perm.new_zeros(pad)])
        out_valid = torch.cat([out_valid, out_valid.new_zeros(pad)])
    return NmsResult(
        torch.where(out_valid[:, None], top_boxes[perm], 0.0),
        torch.where(out_valid, top_scores[perm], 0.0),
        torch.where(out_valid, top_classes[perm], 0.0),
        out_valid,
    )
