"""Detector backends for the fused forward (port of the JAX package's
`pipeline/backends.py`: `EfficientDetBackend` on its score-kernel path,
`YoloBackend` and `SSDBackend`).

A backend is an `nn.Module` that maps a batch of det-input images to
padded person slots (boxes_px yxyx in det-input space, scores, valid),
`max_persons` per image. Its model is a submodule and its constants
(anchors) are buffers, so a `pipeline.full.ServingProgram` over it exports
them with the program (`pipeline/export.py`).

A backend whose forward copies nothing from the host and never waits for
the device sets `capturable`: the serving forward over it is then
replayed from CUDA graphs (`pipeline/graphs.py`). `EfficientDetBackend`
is; the YOLO and SSD slots still build host constants in their forwards.
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
from human_body_proportion_estimation_tpu_torch.models.ssd_mobilenet import (
    SSDMobileNetV1,
    ssd_postprocess,
)
from human_body_proportion_estimation_tpu_torch.models.yolov5 import (
    YoloV5,
    decode_scored,
)
from human_body_proportion_estimation_tpu_torch.ops import (
    boxes as box_ops,
    image as img_ops,
    nms as nms_ops,
)
from human_body_proportion_estimation_tpu_torch.pipeline.full import (
    select_persons,
)
from human_body_proportion_estimation_tpu_torch.utils.config import (
    PipelineConfig,
)


class EfficientDetBackend(torch.nn.Module):
    """EfficientDet-Lite slot: fused head-score kernel + person-only NMS."""

    capturable = True

    def __init__(self, detector: EfficientDet, config: PipelineConfig,
                 device: torch.device | str):
        super().__init__()
        self.detector = detector
        self.config = config
        det = config.detector
        self.image_hw = (det.input_height, det.input_width)
        # anchors and the box limit depend only on the input size: build
        # them once (buffers of the module, left out of its state_dict)
        self.register_buffer("anchors", torch.from_numpy(generate_anchors(
            detector.config.anchors, *self.image_hw)).to(device),
            persistent=False)
        self.register_buffer("box_limit", box_ops.hw_scale(
            *map(float, self.image_hw), device), persistent=False)

    def forward(self, images_f32: torch.Tensor,
                det_threshold: torch.Tensor):
        det = self.config.detector
        best_logit, person_logit, box_regs = self.detector(images_f32)
        return person_slots(
            best_logit, person_logit, box_regs, self.anchors,
            self.box_limit, det_threshold,
            iou_threshold=det.iou_threshold,
            top_k=det.nms_top_k,
            max_persons=det.max_persons,
        )


class YoloBackend(torch.nn.Module):
    """YOLOv5 slot: letterbox 640 gray-128 (reference
    `obj_det_yolov5_trtserver.py:30-37`) -> /255 -> forward -> anchor
    decode with the class reduction on the logits -> official NMS conf 0.4
    / IoU 0.5, person class only (:40-44), the whole batch in ONE sweep
    kernel launch -> un-letterbox (`scale_coords`, :153-154) -> person
    slots."""

    PERSON_CLASS = 0     # 0-based COCO "person" (reference COCO names :17-27)
    CONF_THRES = 0.4     # reference obj_det_yolov5_trtserver.py:40-44
    IOU_THRES = 0.5

    def __init__(self, model: YoloV5, config: PipelineConfig,
                 input_size: int = 640):
        super().__init__()
        self.model = model
        self.config = config
        self.input_size = input_size  # 640, reference :30-37

    def forward(self, images_f32: torch.Tensor,
                det_threshold: torch.Tensor):
        det = self.config.detector
        s = self.input_size
        boxed = img_ops.letterbox(images_f32, s, s)
        heads = self.model((boxed / 255.0).permute(0, 3, 1, 2).contiguous())
        bxywh, obj, best_cls, best_logit = decode_scored(
            heads, self.model.config.num_classes)
        res = nms_ops.yolo_nms_scored(
            bxywh, obj, best_cls, best_logit,
            conf_thres=self.CONF_THRES,
            iou_thres=self.IOU_THRES,
            max_det=det.max_detections,
            top_k=det.nms_top_k,
            class_filter=self.PERSON_CLASS,
        )
        xyxy = box_ops.scale_coords_letterbox(
            res.boxes, (s, s), (det.input_height, det.input_width))
        yxyx = xyxy[..., [1, 0, 3, 2]]
        return select_persons(
            yxyx, res.scores, res.classes, res.valid, det_threshold,
            self.PERSON_CLASS, det.max_persons,
        )


class SSDBackend(torch.nn.Module):
    """SSD-MobileNetV1 slot (the JAX package's default detector, with the
    real weights of the reference's checked-in ssd.tflite): the det-input
    image resized to 300x300 as `jax.image.resize(..., "linear",
    antialias=False)` does, the forward, `ssd_postprocess` for the whole
    batch in ONE NMS sweep launch ([B, 128] class-offset candidates), the
    normalized yxyx boxes mapped to det-input pixels, then the person
    slots (class 0 of the background-stripped ids)."""

    INPUT_SIZE = 300
    PERSON_CLASS = 0  # background-stripped tflite ids

    def __init__(self, model: SSDMobileNetV1, config: PipelineConfig,
                 anchors: torch.Tensor):
        super().__init__()
        self.model = model
        self.config = config
        # [1917, 4] normalized (cy, cx, h, w), from the blob; a buffer of
        # the module (left out of its state_dict), as EfficientDet's
        self.register_buffer("anchors", anchors.float(), persistent=False)

    def forward(self, images_f32: torch.Tensor,
                det_threshold: torch.Tensor):
        det = self.config.detector
        s = self.INPUT_SIZE
        ssd_in = img_ops._resize(images_f32, s, s, "linear", False)
        box_regs, logits = self.model(ssd_in)
        res = ssd_postprocess(box_regs, logits, self.anchors)
        h, w = float(det.input_height), float(det.input_width)
        scale = torch.tensor([h, w, h, w], dtype=torch.float32,
                             device=res.boxes.device)
        return select_persons(
            res.boxes * scale, res.scores, res.classes, res.valid,
            det_threshold, self.PERSON_CLASS, det.max_persons,
        )
