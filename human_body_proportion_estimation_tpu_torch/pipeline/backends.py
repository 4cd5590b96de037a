"""Detector backend for the fused forward (port of the JAX package's
`pipeline/backends.EfficientDetBackend`, score-kernel path).

A backend maps a batch of det-input images to padded person slots
(boxes_px yxyx in det-input space, scores, valid), `max_persons` per image.
"""

from __future__ import annotations

import torch

from human_body_proportion_estimation_tpu_torch.models.anchors import (
    generate_anchors,
)
from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EfficientDet,
    person_slots,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)


class EfficientDetBackend:
    """EfficientDet-Lite slot: fused head-score kernel + person-only NMS."""

    def __init__(self, detector: EfficientDet, config: PipelineConfig,
                 device: torch.device | str):
        self.detector = detector
        self.config = config
        det = config.detector
        self.image_hw = (det.input_height, det.input_width)
        # anchors depend only on the input size: build them once
        self.anchors = torch.from_numpy(generate_anchors(
            detector.config.anchors, *self.image_hw)).to(device)

    def __call__(self, images_f32: torch.Tensor,
                 det_threshold: torch.Tensor):
        det = self.config.detector
        best_logit, person_logit, box_regs = self.detector(images_f32)
        return person_slots(
            best_logit, person_logit, box_regs, self.anchors, self.image_hw,
            det_threshold,
            iou_threshold=det.iou_threshold,
            top_k=det.nms_top_k,
            max_persons=det.max_persons,
        )
