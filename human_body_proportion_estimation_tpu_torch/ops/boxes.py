"""Box coordinate math (port of the JAX package's `ops/boxes.py`).

Two box orders are kept distinct, as in the JAX package:
  * ``xyxy``: (x1, y1, x2, y2) — NMS input, YOLOv5 paths.
  * ``yxyx``: (y1, x1, y2, x2) — EfficientDet / TF detection boxes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def xyxy2xywh(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] corner -> center-size (reference onnx_utils.py:269-277)."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] center-size -> corner (reference onnx_utils.py:280-288)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M].

    Same operation order as the JAX `box_iou`, so the division form
    `inter / max(union, 1e-12)` rounds identically.
    """
    area_a = (a[..., 2:] - a[..., :2]).clamp_min(0.0).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).clamp_min(0.0).prod(-1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp_min(0.0).prod(-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def clip_xyxy(b: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Clip xyxy boxes to image bounds (reference onnx_utils.py:238-249)."""
    return torch.stack([
        b[..., 0].clamp(0, width), b[..., 1].clamp(0, height),
        b[..., 2].clamp(0, width), b[..., 3].clamp(0, height),
    ], -1)


def scale_coords_letterbox(
    boxes_xyxy: torch.Tensor,
    model_hw: Tuple[int, int],
    orig_hw: Tuple[int, int],
) -> torch.Tensor:
    """Invert `ops/image.letterbox` back to original-image pixel coords
    (reference `scale_coords`, `modules/onnx_utils.py:252-266`):
    gain = max(model) / max(orig); pad = (model - orig * gain) / 2;
    subtract the pad, divide by the gain, clip."""
    mh, mw = model_hw
    oh, ow = orig_hw
    gain = max(mh, mw) / max(oh, ow)
    pad_x = (mw - ow * gain) / 2
    pad_y = (mh - oh * gain) / 2
    pad = torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=boxes_xyxy.dtype,
                       device=boxes_xyxy.device)
    return clip_xyxy((boxes_xyxy - pad) / gain, oh, ow)


def expand_clip_normalize_yxyx(
    boxes_yxyx: torch.Tensor,
    x_expand: float,
    y_expand: float,
    height: int,
    width: int,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grow yxyx pixel boxes by +/- (x, y) margins, clip, normalize to [0,1]
    (reference `models/conv.py:39-57`). `scale`: [height, width, height,
    width] f32 on the boxes' device, if the caller holds it there (made
    here otherwise, a copy from the host)."""
    hf, wf = float(height), float(width)
    y1 = (boxes_yxyx[..., 0] - y_expand).clamp(0.0, hf)
    x1 = (boxes_yxyx[..., 1] - x_expand).clamp(0.0, wf)
    y2 = (boxes_yxyx[..., 2] + y_expand).clamp(0.0, hf)
    x2 = (boxes_yxyx[..., 3] + x_expand).clamp(0.0, wf)
    expanded = torch.stack([y1, x1, y2, x2], dim=-1)
    if scale is None:
        scale = hw_scale(hf, wf, boxes_yxyx.device)
    return expanded / scale


def hw_scale(height: float, width: float, device=None) -> torch.Tensor:
    """[height, width, height, width] f32: the per-coordinate scale (or
    limit) of a yxyx box in an image of that size."""
    return torch.tensor([height, width, height, width], dtype=torch.float32,
                        device=device)
