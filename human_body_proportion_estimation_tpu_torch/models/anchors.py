"""Anchor generation + box decoding (port of the JAX package's
`models/anchors.py`).

Anchors are generated once per input size with numpy; decoding is the
standard (ty, tx, th, tw) -> (cy, cx, h, w) faster-rcnn parameterization.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    min_level: int = 3
    max_level: int = 7
    num_scales: int = 3
    aspect_ratios: Tuple[float, ...] = (1.0, 2.0, 0.5)
    anchor_scale: float = 3.0  # lite models use 3.0 (D-series use 4.0)

    @property
    def anchors_per_cell(self) -> int:
        return self.num_scales * len(self.aspect_ratios)


def generate_anchors(
    cfg: AnchorConfig, image_h: int, image_w: int
) -> np.ndarray:
    """All anchors [(sum_l Hl*Wl*A), 4] as pixel (cy, cx, h, w), level-major.

    Cell centers at (i+0.5)*stride; box size anchor_scale * stride * 2^(s/S)
    with aspect split w = size*sqrt(ar), h = size/sqrt(ar).
    """
    out = []
    for level in range(cfg.min_level, cfg.max_level + 1):
        stride = 2 ** level
        fh, fw = -(-image_h // stride), -(-image_w // stride)
        cy = (np.arange(fh) + 0.5) * stride
        cx = (np.arange(fw) + 0.5) * stride
        sizes = []
        for s in range(cfg.num_scales):
            base = cfg.anchor_scale * stride * (2 ** (s / cfg.num_scales))
            for ar in cfg.aspect_ratios:
                sizes.append((base / np.sqrt(ar), base * np.sqrt(ar)))
        sizes = np.array(sizes, np.float32)  # [A, 2] (h, w)
        grid_cy, grid_cx = np.meshgrid(cy, cx, indexing="ij")
        centers = np.stack([grid_cy, grid_cx], -1).reshape(fh, fw, 1, 2)
        hw = np.broadcast_to(sizes, (fh, fw, len(sizes), 2))
        anchors = np.concatenate(
            [np.broadcast_to(centers, hw.shape), hw], axis=-1
        )  # [fh, fw, A, 4] (cy, cx, h, w)
        out.append(anchors.reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def decode_boxes(
    regressions: torch.Tensor, anchors: torch.Tensor
) -> torch.Tensor:
    """(ty, tx, th, tw) regressions [..., 4] + (cy, cx, h, w) pixel anchors
    [..., 4] -> pixel yxyx boxes [..., 4]."""
    ty, tx, th, tw = regressions.unbind(-1)
    cy_a, cx_a, h_a, w_a = anchors.unbind(-1)
    cy = ty * h_a + cy_a
    cx = tx * w_a + cx_a
    h = torch.exp(th) * h_a
    w = torch.exp(tw) * w_a
    return torch.stack(
        [cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1
    )


def feature_shapes(
    cfg: AnchorConfig, image_h: int, image_w: int
) -> List[Tuple[int, int]]:
    """(H, W) of each pyramid level's feature map, levels min..max: the
    input size divided by 2^level, rounded up."""
    return [
        (-(-image_h // 2 ** lvl), -(-image_w // 2 ** lvl))
        for lvl in range(cfg.min_level, cfg.max_level + 1)
    ]
