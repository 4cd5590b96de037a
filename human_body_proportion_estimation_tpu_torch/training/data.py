"""Training data pipeline for top-down pose fine-tuning (the port's own
copy of the JAX package's `training/data.py`, numpy + cv2).

The reference is inference-only; this module supplies what its model zoo
implies but never ships: a COCO-keypoint-format dataset reader, the
standard top-down cropping/augmentation recipe (box -> padded crop with
random scale/rotation/flip, keypoints transformed alongside), and batched
gaussian heatmap targets — everything the train step
(`training/trainer.py`) consumes, as numpy arrays in the JAX
package's NHWC layout.

Augmentation math uses one affine map per sample: crop-space pixel p maps
from image space via p = A @ [x, y, 1]^T, so keypoints ride the exact same
transform as the pixels (no drift between image and labels).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, List, Sequence, Tuple

import numpy as np

# COCO left/right keypoint pairs for horizontal flip (eye, ear, shoulder,
# elbow, wrist, hip, knee, ankle)
FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
              (13, 14), (15, 16))


@dataclasses.dataclass
class PoseSample:
    image: np.ndarray       # HWC uint8 RGB
    keypoints: np.ndarray   # [17, 2] image-space (x, y)
    visible: np.ndarray     # [17] bool
    bbox_xywh: np.ndarray   # [4] person box


def load_coco_keypoints(
    annotation_path: str, image_root: str
) -> List[dict]:
    """Parse a COCO person-keypoints JSON into flat sample records."""
    import os

    with open(annotation_path) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    samples = []
    for ann in coco["annotations"]:
        if ann.get("num_keypoints", 0) <= 0:
            continue
        im = images[ann["image_id"]]
        kp = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
        samples.append({
            "path": os.path.join(image_root, im["file_name"]),
            "keypoints": kp[:, :2],
            "visible": kp[:, 2] > 0,
            "bbox_xywh": np.asarray(ann["bbox"], np.float32),
        })
    return samples


def _affine(center, scale_wh, rotation_deg, out_w, out_h) -> np.ndarray:
    """2x3 image->crop affine: the box (center, scale) fills the output."""
    theta = np.deg2rad(rotation_deg)
    sx = out_w / scale_wh[0]
    sy = out_h / scale_wh[1]
    cos, sin = np.cos(theta), np.sin(theta)
    # rotate about center, then scale to output, then translate to center
    m = np.array([
        [cos * sx, -sin * sx, 0.0],
        [sin * sy, cos * sy, 0.0],
    ], np.float64)
    shift = m[:, :2] @ (-np.asarray(center))
    m[:, 2] = shift + np.array([out_w / 2, out_h / 2])
    return m.astype(np.float32)


def crop_sample(
    sample: PoseSample,
    out_w: int,
    out_h: int,
    scale_jitter: float = 0.0,
    rotation_deg: float = 0.0,
    flip: bool = False,
    padding: float = 1.25,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Person box -> augmented crop + transformed keypoints.

    Standard top-down recipe: the box is padded (1.25x), aspect-corrected
    to the crop ratio, optionally scale-jittered and rotated; horizontal
    flip swaps the left/right keypoint ids.

    Returns (crop f32 [out_h, out_w, 3] in [0,1], keypoints [17, 2] in
    crop pixels, visible [17] — points leaving the crop are marked
    invisible).
    """
    import cv2

    x, y, w, h = sample.bbox_xywh
    center = np.array([x + w / 2, y + h / 2], np.float32)
    aspect = out_w / out_h
    if w / h > aspect:
        h = w / aspect
    else:
        w = h * aspect
    scale = np.array([w, h], np.float32) * padding
    if scale_jitter and rng is not None:
        scale *= rng.uniform(1 - scale_jitter, 1 + scale_jitter)

    m = _affine(center, scale, rotation_deg, out_w, out_h)
    crop = cv2.warpAffine(
        sample.image, m, (out_w, out_h), flags=cv2.INTER_LINEAR
    ).astype(np.float32) / 255.0

    ones = np.ones((17, 1), np.float32)
    kp = (np.concatenate([sample.keypoints, ones], 1) @ m.T)
    vis = sample.visible.copy()

    if flip:
        crop = crop[:, ::-1].copy()
        kp[:, 0] = out_w - 1 - kp[:, 0]
        for a, b in FLIP_PAIRS:
            kp[[a, b]] = kp[[b, a]]
            vis[[a, b]] = vis[[b, a]]

    inside = (
        (kp[:, 0] >= 0) & (kp[:, 0] < out_w)
        & (kp[:, 1] >= 0) & (kp[:, 1] < out_h)
    )
    return crop, kp, vis & inside


def batch_iterator(
    samples: Sequence[PoseSample],
    batch_size: int,
    crop_hw: Tuple[int, int] = (384, 288),
    heatmap_downscale: int = 4,
    augment: bool = True,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (images [B,H,W,3] f32, kp_heatmap_coords [B,17,2],
    visible [B,17]) batches, shuffled each epoch, indefinitely."""
    rng = np.random.default_rng(seed)
    h, w = crop_hw
    while True:
        order = rng.permutation(len(samples))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            imgs, kps, viss = [], [], []
            for idx in order[start:start + batch_size]:
                s = samples[idx]
                crop, kp, vis = crop_sample(
                    s, w, h,
                    scale_jitter=0.25 if augment else 0.0,
                    rotation_deg=float(rng.uniform(-30, 30)) if augment else 0.0,
                    flip=bool(rng.random() < 0.5) if augment else False,
                    rng=rng,
                )
                imgs.append(crop)
                kps.append(kp / heatmap_downscale)
                viss.append(vis)
            yield (
                np.stack(imgs),
                np.stack(kps).astype(np.float32),
                np.stack(viss),
            )
