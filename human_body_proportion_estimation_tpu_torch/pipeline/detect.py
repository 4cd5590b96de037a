"""Detection-only forwards, EfficientDet and YOLOv5 (port of the JAX
package's `pipeline/detect.py`).

Mirrors the reference's standalone detector demos:
  * EfficientDet path (`obj_det_edet4_trtserver.py`): uint8 image at the
    model size -> 100 detection slots (pixel y1x1y2x2 + scores + 1-based
    classes), the "modified" SavedModel output schema (:22-37), through
    the canonical all-class head and `models/efficientdet.postprocess`.
  * YOLOv5 path (`obj_det_yolov5_trtserver.py` / `obj_det_yolov5_onnx.py`):
    letterboxed 640x640 float input -> anchor-decoded predictions ->
    class-offset NMS -> boxes scaled back to the original image (xyxy +
    conf + class, reference onnx_utils.py NMS + scale_coords).
A batch's NMS is one sweep kernel launch on CUDA, on either path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from human_body_proportion_estimation_tpu_torch.models.anchors import (
    generate_anchors,
)
from human_body_proportion_estimation_tpu_torch.models.efficientdet import (
    EfficientDet,
    postprocess as edet_postprocess,
)
from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
    YoloV5,
    decode_predictions,
)
from human_body_proportion_estimation_tpu_torch.ops import boxes as box_ops
from human_body_proportion_estimation_tpu_torch.ops.nms import (
    yolo_nms,
    yolo_nms_legacy,
)


class Detections(NamedTuple):
    boxes: torch.Tensor    # [B, N, 4]
    scores: torch.Tensor   # [B, N]
    classes: torch.Tensor  # [B, N]
    valid: torch.Tensor    # [B, N] bool


class EdetDetectPipeline:
    """uint8 [B, H, W, 3] at `input_hw` -> 100 yxyx pixel detections a
    image (1-based classes), on the detector's device."""

    def __init__(self, detector: EfficientDet, input_hw: Tuple[int, int],
                 iou_threshold: float = 0.5, top_k: int = 128):
        self.detector = detector
        self.input_hw = input_hw
        self.iou_threshold = iou_threshold
        self.top_k = top_k
        device = next(detector.parameters()).device
        self.anchors = torch.from_numpy(generate_anchors(
            detector.config.anchors, *input_hw)).to(device)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Detections:
        cls_logits, box_regs = self.detector(images.float(),
                                             all_classes=True)
        boxes, scores, classes, valid = edet_postprocess(
            cls_logits, box_regs, self.input_hw, self.anchors,
            self.detector.config, iou_threshold=self.iou_threshold,
            top_k=self.top_k,
        )
        return Detections(boxes, scores, classes, valid)

    __call__ = forward


class YoloDetectPipeline:
    """Letterboxed f32 [B, S, S, 3] in [0, 1] (NHWC, as the JAX program
    takes it) -> NMS'd xyxy detections in letterbox pixels."""

    def __init__(self, model: YoloV5, conf_thres: float = 0.4,
                 iou_thres: float = 0.5, max_det: int = 300,
                 top_k: int = 512, class_filter: Optional[int] = None,
                 legacy_nms: bool = False,
                 num_classes: Optional[int] = None):
        self.model = model
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.top_k = top_k
        self.class_filter = class_filter
        # legacy mode = the reference's second postprocess
        # (`w_non_max_suppression`, modules/onnx_utils.py:39-95): obj-conf
        # gating + per-class +1-IoU NMS over `num_classes` class columns
        # (the `-c/--num_classes` CLI knob, modules/utils.py:100-102)
        self.legacy_nms = legacy_nms
        self.num_classes = num_classes or model.config.num_classes

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> Detections:
        heads = self.model(images.permute(0, 3, 1, 2).contiguous())
        preds = decode_predictions(heads, self.model.config.num_classes)
        if self.legacy_nms:
            res = yolo_nms_legacy(preds, self.num_classes, self.conf_thres,
                                  self.iou_thres, self.max_det, self.top_k)
        else:
            res = yolo_nms(preds, self.conf_thres, self.iou_thres,
                           self.max_det, self.top_k,
                           class_filter=self.class_filter)
        return Detections(res.boxes, res.scores, res.classes, res.valid)

    __call__ = forward


def letterbox_host(img_rgb: np.ndarray, size: int = 640) -> np.ndarray:
    """Host PIL letterbox to size x size, /255 float32 (the reference YOLO
    preprocess, `obj_det_yolov5_onnx.py:27-36` incl. bicubic + gray pad)."""
    from PIL import Image

    pil = Image.fromarray(img_rgb)
    iw, ih = pil.size
    scale = min(size / iw, size / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = pil.resize((nw, nh), Image.BICUBIC)
    canvas = Image.new("RGB", (size, size), (128, 128, 128))
    canvas.paste(resized, ((size - nw) // 2, (size - nh) // 2))
    return np.asarray(canvas, np.float32) / 255.0


def scale_boxes_to_original(
    boxes_xyxy: np.ndarray, model_size: int, orig_hw: Tuple[int, int]
) -> np.ndarray:
    """Undo the letterbox on detection boxes (reference scale_coords)."""
    out = box_ops.scale_coords_letterbox(
        torch.as_tensor(np.asarray(boxes_xyxy, np.float32)),
        (model_size, model_size), orig_hw)
    return out.numpy()
