"""Keypoint evaluation: COCO OKS / OKS-AP and threshold PCK; the port's own
copy of the JAX package's numpy `metrics/pose.py`.

The pose checkpoints the reference selects (pose_hrnet_w32_384x288,
HigherHRNet — `pose_est_hrnet_trtserver.py:153`) are published with COCO
OKS-AP numbers; this module reproduces that protocol so imported weights
can be validated against them, plus the simpler PCK used by MPII-style
evaluations. Keypoint order is the COCO-17 convention the whole pipeline
uses (`ops/heatmap.py` / reference `modules/pose_estimator.py:16-34`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from human_body_proportion_estimation_tpu_torch.metrics.detection import (
    average_precision,
)

# per-keypoint OKS falloff constants, COCO-17 order (nose, eyes, ears,
# shoulders, elbows, wrists, hips, knees, ankles) — public COCO keypoint
# evaluation protocol constants (cocodataset.org/#keypoints-eval)
COCO_KP_SIGMAS = np.array(
    [.026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
     .107, .107, .087, .087, .089, .089], np.float32)

IOU_SWEEP = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def oks(
    pred_kp: np.ndarray,   # [K, 2] (x, y)
    gt_kp: np.ndarray,     # [K, 2]
    gt_visible: np.ndarray,  # [K] bool
    area: float,
    sigmas: np.ndarray = COCO_KP_SIGMAS,
) -> float:
    """Object keypoint similarity of one prediction against one gt."""
    vis = np.asarray(gt_visible, bool)
    if not vis.any():
        return 0.0
    d2 = np.sum((np.asarray(pred_kp, np.float32)
                 - np.asarray(gt_kp, np.float32)) ** 2, axis=-1)
    k2 = (2.0 * sigmas[: len(d2)]) ** 2
    e = d2 / (2.0 * k2 * max(float(area), 1e-6))
    return float(np.mean(np.exp(-e)[vis]))


def pck(
    pred_kp: np.ndarray,     # [P, K, 2]
    gt_kp: np.ndarray,       # [P, K, 2]
    gt_visible: np.ndarray,  # [P, K] bool
    norm: np.ndarray | float,  # per-person scale (e.g. bbox diagonal)
    threshold: float = 0.5,
) -> float:
    """Fraction of visible keypoints within threshold * norm of the gt
    (PCK; with norm = head-segment length this is MPII PCKh)."""
    vis = np.asarray(gt_visible, bool)
    if not vis.any():
        return float("nan")
    d = np.linalg.norm(
        np.asarray(pred_kp, np.float32) - np.asarray(gt_kp, np.float32),
        axis=-1,
    )
    norm = np.broadcast_to(np.asarray(norm, np.float32).reshape(-1, 1),
                           d.shape)
    correct = d <= threshold * norm
    return float(np.mean(correct[vis]))


def _match_image_oks(
    pred_kps: np.ndarray,    # [N, K, 2]
    pred_scores: np.ndarray,  # [N]
    gt_kps: np.ndarray,       # [M, K, 2]
    gt_visible: np.ndarray,   # [M, K] bool
    gt_areas: np.ndarray,     # [M]
    threshold: float,
) -> np.ndarray:
    """Greedy OKS matching (COCO protocol: score-ordered predictions
    claim the best unclaimed gt with OKS >= threshold)."""
    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    claimed = np.zeros(len(gt_kps), bool)
    tp = np.zeros(len(pred_kps), bool)
    for i in order:
        best, best_j = -1.0, -1
        for j in range(len(gt_kps)):
            if claimed[j]:
                continue
            s = oks(pred_kps[i], gt_kps[j], gt_visible[j],
                    float(gt_areas[j]))
            if s > best:
                best, best_j = s, j
        if best_j >= 0 and best >= threshold:
            claimed[best_j] = True
            tp[i] = True
    return tp


def oks_ap(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    thresholds: Sequence[float] = IOU_SWEEP,
) -> dict:
    """COCO keypoint AP over the OKS sweep .50:.05:.95.

    Args:
        predictions: per image, (kps [N,K,2], scores [N]).
        ground_truths: per image, (kps [M,K,2], visible [M,K], areas [M]).

    Returns {"mAP", "AP50", "AP75", "per_oks"}.
    """
    assert len(predictions) == len(ground_truths)
    n_gt = int(sum(len(g[0]) for g in ground_truths))
    per = {}
    for thr in thresholds:
        scores_all, tp_all = [], []
        for (kps, scores), (g_kps, g_vis, g_area) in zip(predictions,
                                                         ground_truths):
            scores = np.asarray(scores, np.float32).reshape(-1)
            scores_all.append(scores)
            tp_all.append(_match_image_oks(
                np.asarray(kps, np.float32), scores,
                np.asarray(g_kps, np.float32),
                np.asarray(g_vis, bool), np.asarray(g_area, np.float32),
                thr,
            ))
        per[float(thr)] = average_precision(
            np.concatenate(scores_all) if scores_all else np.zeros(0),
            np.concatenate(tp_all) if tp_all else np.zeros(0, bool),
            n_gt,
        )
    aps = list(per.values())
    return {
        "mAP": float(np.mean(aps)) if aps else float("nan"),
        "AP50": per.get(0.5, float("nan")),
        "AP75": per.get(0.75, float("nan")),
        "per_oks": per,
    }
