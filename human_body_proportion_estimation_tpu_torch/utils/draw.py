"""Host-side result rendering (cv2) for the CLI drivers: the port of the
JAX package's `utils/draw.py`.

Drawing is presentation, not compute — it stays on the host, mirroring the
reference's renderers: `plot_one_box` (`modules/utils.py:116-137`),
keypoint/skeleton drawing (`modules/pose_estimator.py:101-128,182-189,
202-214`) and the summed-heatmap plot (`modules/pose_estimator.py:61-72`),
but driven by the framework's mask-based outputs instead of ignored-index
sets.
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from human_body_proportion_estimation_tpu_torch.ops.proportions import (
    _SEGMENT_SPEC,
    NUM_KEYPOINTS,
)


def draw_box(
    frame: np.ndarray,
    box_xyxy: Sequence[float],
    color=None,
    label: str | None = None,
    thickness: int | None = None,
):
    """Rectangle + optional label, in place on an RGB frame."""
    import cv2

    t = thickness or round(
        0.002 * (frame.shape[0] + frame.shape[1]) / 2
    ) + 1
    color = color or [random.randint(0, 255) for _ in range(3)]
    p1 = (int(box_xyxy[0]), int(box_xyxy[1]))
    p2 = (int(box_xyxy[2]), int(box_xyxy[3]))
    cv2.rectangle(frame, p1, p2, color, thickness=t, lineType=cv2.LINE_AA)
    if label:
        tf = max(t - 1, 1)
        size = cv2.getTextSize(label, 0, fontScale=t / 3, thickness=tf)[0]
        cv2.rectangle(
            frame, p1, (p1[0] + size[0], p1[1] - size[1] - 3), color, -1,
            cv2.LINE_AA,
        )
        cv2.putText(
            frame, label, (p1[0], p1[1] - 2), 0, t / 3, (225, 255, 255),
            thickness=tf, lineType=cv2.LINE_AA,
        )


def draw_keypoints(
    frame: np.ndarray,
    keypoints: np.ndarray,       # [17, 2] (x, y)
    visible: np.ndarray | None,  # [17] bool
    color=(0, 0, 255),
):
    """Numbered keypoint dots for visible joints."""
    import cv2

    for i in range(NUM_KEYPOINTS):
        if visible is not None and not bool(visible[i]):
            continue
        x, y = int(keypoints[i, 0]), int(keypoints[i, 1])
        cv2.putText(frame, str(i), (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    color)
        cv2.circle(frame, (x, y), max(frame.shape[0] // 150, 2), color, -1)


def draw_skeleton(
    frame: np.ndarray,
    keypoints: np.ndarray,        # [17, 2]
    seg_visible: np.ndarray,      # [11] bool
    color=(0, 0, 255),
    thickness: int = 1,
):
    """Lines for the 11 visible body segments (incl. chest/crotch torso)."""
    import cv2

    kp = np.asarray(keypoints, np.float64)
    for s, (_, w1, w2) in enumerate(_SEGMENT_SPEC):
        if not bool(seg_visible[s]):
            continue
        p1 = sum(kp[k] * v for k, v in w1.items())
        p2 = sum(kp[k] * v for k, v in w2.items())
        cv2.line(
            frame, (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1])),
            color, max(thickness, 1),
        )


def save_heatmap_plot(heatmap: np.ndarray, path: str, scale: int = 10):
    """Sum the [K, H, W] heatmaps into one hot-colormap image file.

    The JAX package plots the sum with matplotlib; the port draws the same
    map with cv2's HOT colormap (min to max of the sum, each heatmap pixel
    a `scale` x `scale` block, no axes), so that it needs no matplotlib."""
    import cv2

    combined = np.nan_to_num(np.sum(np.asarray(heatmap, np.float64), axis=0))
    lo, hi = float(combined.min()), float(combined.max())
    gray = np.zeros(combined.shape, np.uint8) if hi <= lo else (
        (combined - lo) / (hi - lo) * 255.0).round().astype(np.uint8)
    img = cv2.applyColorMap(gray, cv2.COLORMAP_HOT)
    cv2.imwrite(path, cv2.resize(
        img, (img.shape[1] * scale, img.shape[0] * scale),
        interpolation=cv2.INTER_NEAREST))
