"""Pose-only forward on pre-cropped person images (port of the JAX
package's `pipeline/pose.py`).

Mirrors the reference's pose demo (`pose_est_hrnet_trtserver.py`): RGB/255
images resized to the crop size (288x384 W x H, :15-19) -> HRNet or
HigherHRNet heatmaps -> argmax decode (the decode kernel on CUDA), with the
heatmaps in the reference's channel-first [K, H, W] layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from human_body_proportion_estimation_tpu_torch.ops import kernels


class PoseResult(NamedTuple):
    heatmaps: torch.Tensor   # [B, K, Hm, Wm]
    keypoints: torch.Tensor  # [B, K, 2] heatmap coords (x, y)
    scores: torch.Tensor     # [B, K]


class PosePipeline:
    """f32 [B, H, W, 3] in [0, 1] (NHWC, as the JAX program takes it) ->
    heatmaps + decoded keypoints, on the model's device."""

    def __init__(self, model: nn.Module):
        self.model = model

    @torch.inference_mode()
    def forward(self, crops: torch.Tensor) -> PoseResult:
        heatmaps = self.model(crops.permute(0, 3, 1, 2)).contiguous()
        kp, scores = kernels.decode_heatmaps(heatmaps)
        return PoseResult(heatmaps, kp, scores)

    __call__ = forward


def preprocess_crop_host(
    img_rgb: np.ndarray, width: int = 288, height: int = 384
) -> np.ndarray:
    """Host preprocess for pre-cropped person images: /255 then resize,
    in that order (the reference divides before resizing,
    pose_est_hrnet_trtserver.py:16-18; an f32 resize rounds otherwise
    than a uint8 one)."""
    import cv2

    img = img_rgb.astype(np.float32) / 255.0
    return cv2.resize(img, (width, height)).astype(np.float32)
