"""Greedy NMS keep mask over fixed-size candidate sets (port of the JAX
package's `ops/nms.nms_mask`).

This is the plain version of the NMS sweep kernel (`ops/kernels.nms_sweep`)
and the reference the kernel is held against: a box survives iff its score
is > 0 and no earlier (higher-scoring) surviving box overlaps it with
IoU > t, where IoU is the division form of `ops/boxes.box_iou`.
"""

from __future__ import annotations

import torch

from human_body_proportion_estimation_tpu_torch.ops.boxes import box_iou


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
