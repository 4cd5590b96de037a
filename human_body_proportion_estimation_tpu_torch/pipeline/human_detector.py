"""Edge-alternative person detector: SSD-MobileNetV1 with real weights (port
of the JAX package's `pipeline/human_detector.py`).

Parity target: `modules/human_detector.py` (`HumanDetectorTflite`), the
reference's CPU / edge detector slot. The same behaviour: 300x300 uint8
input (cv2 resize), person = class 0 of the background-stripped outputs,
the score-threshold filter (:31-38), and the normalized y1x1y2x2 crop
helper (:41-64). The network runs as the port's module, on `device`
("cuda" unless the caller asks for the CPU), with weights dequantized from
the same blob by `models/tflite_import.py`; the postprocess is one NMS
sweep launch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (
    load_ssd,
    ssd_postprocess,
)
from human_body_proportion_estimation_tpu_torch.models.tflite_import import (
    DEFAULT_TFLITE_PATH,
)

PERSON_CLASS = 0  # background-stripped tflite class ids (reference :31-38)


class HumanDetectorSSD:
    """Drop-in analog of the reference's HumanDetectorTflite."""

    def __init__(
        self,
        tflite_path: str = DEFAULT_TFLITE_PATH,
        threshold: float = 0.3,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        self.threshold = threshold
        self.device = torch.device(device)
        self.model, self.anchors = load_ssd(path=tflite_path, dtype=dtype,
                                            device=self.device)

    @torch.inference_mode()
    def get_detections(
        self, image_rgb: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Person boxes (normalized y1x1y2x2) + scores above threshold."""
        import cv2

        inp = cv2.resize(image_rgb, (300, 300)).astype(np.uint8)
        box_regs, logits = self.model(
            torch.from_numpy(inp[None]).to(self.device))
        det = ssd_postprocess(box_regs, logits, self.anchors)
        boxes, classes, scores, valid = (
            t[0].cpu().numpy() for t in (det.boxes, det.classes, det.scores,
                                         det.valid))
        keep = valid & (classes == PERSON_CLASS) & (scores >= self.threshold)
        return boxes[keep], scores[keep]

    def get_crops(self, image_rgb: np.ndarray) -> List[np.ndarray]:
        """Cropped person regions from normalized boxes (reference :41-64)."""
        boxes, _ = self.get_detections(image_rgb)
        h, w = image_rgb.shape[:2]
        crops = []
        for y1, x1, y2, x2 in boxes:
            ya, xa = max(int(y1 * h), 0), max(int(x1 * w), 0)
            yb, xb = min(int(y2 * h), h), min(int(x2 * w), w)
            if yb > ya and xb > xa:
                crops.append(image_rgb[ya:yb, xa:xb])
        return crops
