"""COCO-protocol detection average precision (single class or per-class);
the port's own copy of the JAX package's numpy `metrics/detection.py`.

Implements the standard evaluation the reference leaves to its upstream
model releases (the pretrained YOLOv5/EfficientDet zoos are selected by
their published COCO mAP; the repo itself never measures anything —
SURVEY §6 "not published"): greedy score-ordered matching per image at an
IoU threshold, each ground truth claimable once, 101-point interpolated
precision-recall AP, averaged over the COCO IoU sweep .50:.05:.95.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

IOU_SWEEP = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] xyxy (or yxyx — symmetric) -> [N,M] IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = np.prod(np.maximum(a[:, 2:] - a[:, :2], 0.0), axis=-1)
    area_b = np.prod(np.maximum(b[:, 2:] - b[:, :2], 0.0), axis=-1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.maximum(rb - lt, 0.0), axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-12)


def match_image(
    det_boxes: np.ndarray,   # [N, 4]
    det_scores: np.ndarray,  # [N]
    gt_boxes: np.ndarray,    # [M, 4]
    iou_threshold: float,
) -> np.ndarray:
    """Greedy COCO matching for one image: detections in descending
    score order each claim the highest-IoU unclaimed gt above the
    threshold. Returns [N] bool — True where the detection is a true
    positive — aligned with the input order."""
    order = np.argsort(-det_scores, kind="stable")
    iou = _iou_matrix(det_boxes, gt_boxes)
    claimed = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(det_boxes), bool)
    for i in order:
        if len(gt_boxes) == 0:
            break
        cand = np.where(claimed, -1.0, iou[i])
        j = int(np.argmax(cand))
        if cand[j] >= iou_threshold:
            claimed[j] = True
            tp[i] = True
    return tp


def average_precision(
    scores: np.ndarray,  # [N] all detections across the dataset
    tp: np.ndarray,      # [N] bool true-positive flags
    n_gt: int,
) -> float:
    """101-point interpolated AP (COCO recThrs 0:.01:1)."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp_c = np.cumsum(tp[order])
    fp_c = np.cumsum(~tp[order])
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    rec_thrs = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, rec_thrs, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx,
                 len(precision) - 1)], 0.0)
    return float(np.mean(p))


def detection_ap(
    detections: Sequence[Tuple[np.ndarray, np.ndarray]],
    ground_truths: Sequence[np.ndarray],
    iou_thresholds: Sequence[float] = IOU_SWEEP,
) -> dict:
    """Dataset AP for one class.

    Args:
        detections: per image, (boxes [N,4], scores [N]).
        ground_truths: per image, gt boxes [M,4].

    Returns {"mAP": mean over the IoU sweep, "AP50": ..., "AP75": ...,
    "per_iou": {thr: ap}}.
    """
    assert len(detections) == len(ground_truths)
    n_gt = int(sum(len(g) for g in ground_truths))
    per_iou = {}
    for thr in iou_thresholds:
        all_scores: List[np.ndarray] = []
        all_tp: List[np.ndarray] = []
        for (boxes, scores), gts in zip(detections, ground_truths):
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
            scores = np.asarray(scores, np.float32).reshape(-1)
            all_scores.append(scores)
            all_tp.append(match_image(boxes, scores,
                                      np.asarray(gts, np.float32)
                                      .reshape(-1, 4), thr))
        per_iou[float(thr)] = average_precision(
            np.concatenate(all_scores) if all_scores else np.zeros(0),
            np.concatenate(all_tp) if all_tp else np.zeros(0, bool),
            n_gt,
        )
    aps = list(per_iou.values())
    return {
        "mAP": float(np.mean(aps)) if aps else float("nan"),
        "AP50": per_iou.get(0.5, float("nan")),
        "AP75": per_iou.get(0.75, float("nan")),
        "per_iou": per_iou,
    }
