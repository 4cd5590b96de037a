"""Box coordinate math (port of the JAX package's `ops/boxes.py`).

Two box orders are kept distinct, as in the JAX package:
  * ``xyxy``: (x1, y1, x2, y2) — NMS input.
  * ``yxyx``: (y1, x1, y2, x2) — EfficientDet / TF detection boxes.
"""

from __future__ import annotations

import torch


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


def expand_clip_normalize_yxyx(
    boxes_yxyx: torch.Tensor,
    x_expand: float,
    y_expand: float,
    height: int,
    width: int,
) -> torch.Tensor:
    """Grow yxyx pixel boxes by +/- (x, y) margins, clip, normalize to [0,1]
    (reference `models/conv.py:39-57`)."""
    hf, wf = float(height), float(width)
    y1 = (boxes_yxyx[..., 0] - y_expand).clamp(0.0, hf)
    x1 = (boxes_yxyx[..., 1] - x_expand).clamp(0.0, wf)
    y2 = (boxes_yxyx[..., 2] + y_expand).clamp(0.0, hf)
    x2 = (boxes_yxyx[..., 3] + x_expand).clamp(0.0, wf)
    expanded = torch.stack([y1, x1, y2, x2], dim=-1)
    scale = torch.tensor([hf, wf, hf, wf], dtype=torch.float32,
                         device=boxes_yxyx.device)
    return expanded / scale
