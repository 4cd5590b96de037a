"""Seeded weights, inputs and decision margins of the port's
EfficientDet-Lite0 detector and HigherHRNet pose slots, shared by the slot
tests (tests/test_torch_port_slots.py), the goldens generator
(tests/test_torch_port_slot_goldens.py) and `chip_smoke.py` phase D,
which loads this file by its path: it imports the port, torch and numpy,
nothing of JAX.

No weights for these slots are in the repository, so both sides load the
same numbers: `models.weights.seeded_state` (a numpy generator, BatchNorm
statistics calibrated on the inputs the test feeds; for Lite0 the class
and box predict convs scaled to logits of standard deviation 1 there and
a bias added to every class logit, so that a handful of anchors clear the
detection threshold).
"""

import os

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models.anchors import (
    decode_boxes,
    generate_anchors,
)
from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EFFICIENTDET_LITE0,
    EfficientDet,
)
from human_body_proportion_estimation_tpu_torch.models.higherhrnet import (
    HigherHRNet,
)
from human_body_proportion_estimation_tpu_torch.models.weights import (
    seeded_state,
)
from human_body_proportion_estimation_tpu_torch.ops.boxes import box_iou
from human_body_proportion_estimation_tpu_torch.pipeline.pose import (
    preprocess_crop_host,
)

DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "torch_port")
SCENES = ("scene_0.png", "scene_1.png", "scene_2.png")
DET_HW = (480, 640)
CROP_HW = (384, 288)
DET_THRESHOLD = 0.6      # the CLIs' -t default, detect_edet's cut
IOU_THRESHOLD = 0.5
TOP_K = 128
HEADS = ("class_net.predict_pw", "box_net.predict_pw")
CLASS_BIAS_KEY = "class_net.predict_pw.bias"


def scenes() -> np.ndarray:
    """The three committed 480x640 scenes, RGB uint8 [3, 480, 640, 3]."""
    import cv2

    return np.stack([cv2.imread(os.path.join(DATA_DIR, name))[..., ::-1]
                     for name in SCENES])


def crops(images: np.ndarray) -> np.ndarray:
    """Each image as the pose CLI feeds it (`preprocess_crop_host`: /255,
    then resized to 288x384), f32 NCHW [n, 3, 384, 288]."""
    h, w = CROP_HW
    return np.ascontiguousarray(np.stack(
        [preprocess_crop_host(img, w, h) for img in images]
    ).transpose(0, 3, 1, 2))


def lite0_state(seed: int, class_bias: float, images: np.ndarray):
    """numpy state dict of EfficientDet-Lite0, calibrated on `images`
    (uint8 NHWC at 480x640)."""
    return seeded_state(
        EfficientDet(EFFICIENTDET_LITE0, dtype=torch.float64), seed,
        lambda m: m(torch.from_numpy(images), all_classes=True),
        heads=HEADS, bias={CLASS_BIAS_KEY: class_bias})


def higher_state(seed: int, crops_nchw: np.ndarray):
    """numpy state dict of HigherHRNet (W32 trunk), calibrated on
    `crops_nchw`."""
    return seeded_state(HigherHRNet(dtype=torch.float64), seed,
                        lambda m: m(torch.from_numpy(crops_nchw)))


def to_torch(state):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def lite0_margins(cls_logits: torch.Tensor, box_regs: torch.Tensor,
                  det_threshold: float = DET_THRESHOLD):
    """How far each decision of the Lite0 detection path lies from
    flipping, image by image, from the canonical head's f32 outputs: over
    the candidates (anchors among the top 128 whose score passes the
    threshold), the gaps between their sorted scores (NMS and slot order),
    their class logits' lead over the next class, and their same-class
    IoUs' distance from 0.5; and each candidate score's distance from the
    threshold. Returns a list of dicts of floats (inf where a decision
    does not arise) and the candidates per image."""
    inf = float("inf")
    anchors = torch.from_numpy(generate_anchors(EFFICIENTDET_LITE0.anchors,
                                                *DET_HW))
    h, w = DET_HW
    limit = torch.tensor([h, w, h, w], dtype=torch.float32)
    out, counts = [], []
    for logits, regs in zip(cls_logits, box_regs):
        top2 = torch.topk(logits, 2, -1).values
        score = torch.sigmoid(top2[:, 0])
        order = torch.sort(score, descending=True, stable=True).indices
        cand = order[:TOP_K][score[order[:TOP_K]] >= det_threshold]
        s = score[cand]
        m = {"det_threshold": float((score[order[:TOP_K]] - det_threshold)
                                    .abs().min())}
        m["score_order"] = float((s[:-1] - s[1:]).min()) if len(s) > 1 \
            else inf
        m["class_lead"] = float((top2[cand, 0] - top2[cand, 1]).min()) \
            if len(cand) else inf
        boxes = decode_boxes(regs[cand], anchors[cand]).clamp_min(0.0)
        boxes = boxes.minimum(limit)[:, [1, 0, 3, 2]]
        cls = logits[cand].argmax(-1)
        same = (cls[:, None] == cls[None, :]) & torch.triu(
            torch.ones(len(cand), len(cand), dtype=torch.bool), 1)
        iou = box_iou(boxes, boxes)
        m["iou"] = float((iou[same] - IOU_THRESHOLD).abs().min()) \
            if same.any() else inf
        out.append(m)
        counts.append(len(cand))
    return out, counts


def heatmap_summary(maps: np.ndarray):
    """[n, C, H, W] -> (per-map max [n][C], argmax [n][C] of the flattened
    map, and the smallest gap between a map's two largest values relative
    to the largest's magnitude: how far its argmax lies from flipping)."""
    flat = np.asarray(maps, np.float32).reshape(*maps.shape[:2], -1)
    top2 = np.sort(flat, -1)[..., -2:]
    rel = (top2[..., 1] - top2[..., 0]) / np.maximum(np.abs(top2[..., 1]),
                                                     1e-6)
    return (flat.max(-1).tolist(), flat.argmax(-1).tolist(),
            float(rel.min()))
