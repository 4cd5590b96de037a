"""Single typed config tree for the PyTorch port.

The same frozen dataclasses, field for field, as the JAX package's
`utils/config.py`, so one configuration means the same shapes, thresholds
and keypoint gates in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Person detector configuration (EfficientDet-Lite4 slot).

    Reference defaults: det input 640x480 W x H
    (`person_det_pose_edet4_trtserver.py:15`), det threshold 0.70 HTTP form /
    0.80 pydantic (`uvicorn_server/server.py:88,27`), person class id 1
    (`models/conv.py:22`), top-3 person cap (`models/conv.py:35`).
    """

    name: str = "efficientdet_lite4"
    input_height: int = 480
    input_width: int = 640
    default_threshold: float = 0.70
    person_class_id: int = 1  # 1-based COCO "person", reference models/conv.py:22
    max_persons: int = 3
    max_detections: int = 100  # raw detector output slots, reference conv.py:16
    iou_threshold: float = 0.5
    # candidates entering the KxK NMS stage: the suppression sweep is a
    # sequential fori_loop, so K directly sets its depth; 128 covers the
    # 100-slot output contract with margin at 4x less loop latency than 512
    nms_top_k: int = 128


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Top-down pose model configuration (HRNet slot).

    Reference: crop size 384x288 H x W (`models/conv.py:61`), 17 COCO
    keypoints (`modules/pose_estimator.py:9-17`), heatmaps at 1/4 resolution
    (96x72), per-keypoint confidence gates
    (`person_det_pose_edet4_trtserver.py:62-63`).
    """

    name: str = "hrnet_w32"
    crop_height: int = 384
    crop_width: int = 288
    num_keypoints: int = 17
    heatmap_height: int = 96
    heatmap_width: int = 72
    # nose, reye, leye, rear, lear, rshoulder, lshoulder, relbow, lelbow,
    # rwrist, lwrist, rhip, lhip, rknee, lknee, rankle, lankle
    keypoint_thresholds: Tuple[float, ...] = (
        0.45, 0.46, 0.45, 0.40, 0.34, 0.10, 0.10, 0.10, 0.10,
        0.24, 0.30, 0.11, 0.10, 0.15, 0.10, 0.25, 0.20,
    )
    # quarter-pixel argmax refinement (standard HRNet post-process); OFF by
    # default for exact reference parity (the reference uses plain argmax)
    subpixel_refine: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving edge + dynamic batching queue (the Triton replacement)."""

    host: str = "0.0.0.0"
    port: int = 8080
    max_batch: int = 16
    batch_timeout_ms: float = 4.0
    queue_depth: int = 256
    default_person_height_cm: int = 175  # reference server.py:27
    # prefer the C++ serving core (native/serving_core.cpp) for queueing/
    # deadline batching, falling back to the Python batcher if the native
    # library can't be built
    native_batcher: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config: detector + pose + serving + execution knobs."""

    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    pose: PoseConfig = dataclasses.field(default_factory=PoseConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    # bbox x-expand before the pose crop: w // 17, y-expand 0
    # (reference person_det_pose_edet4_trtserver.py:116-117)
    bbox_x_expand_divisor: int = 17
    compute_dtype: str = "bfloat16"  # conv/matmul compute; f32 accumulation
    param_dtype: str = "float32"

    @property
    def x_expand(self) -> int:
        return self.detector.input_width // self.bbox_x_expand_divisor


def config_from_dict(d: dict) -> PipelineConfig:
    """Rebuild the frozen config tree from `dataclasses.asdict` output (a
    serving artifact's `meta.json`, `pipeline/export.py`): the JAX
    package's `config_from_dict`. Unknown keys (from a newer writer) are
    dropped; JSON lists become the tuples the dataclasses expect."""
    def build(cls, sub: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in sub.items() if k in names})

    return PipelineConfig(
        detector=build(DetectorConfig, d.get("detector", {})),
        pose=build(PoseConfig, d.get("pose", {})),
        serve=build(ServeConfig, d.get("serve", {})),
        **{k: v for k, v in d.items()
           if k in ("bbox_x_expand_divisor", "compute_dtype", "param_dtype")},
    )
