"""YOLOv5 detector, v6.0 CSP architecture (port of the JAX package's
`models/yolov5.py`).

Structure (depth d / width w multiples — s: d=0.33 w=0.50, m: d=0.67
w=0.75): Conv 6x6/2 stem; 4 stride-2 stages with C3 blocks (3/6/9/3 base
depths); SPPF; PANet head (top-down + bottom-up C3 stacks); 1x1 Detect
convs to 3 anchors x (5 + 80) per level P3/P4/P5, computed in f32
whatever the trunk's dtype, as the flax model does.

Module and attribute names are the flax module names (`stem.conv`,
`c3_1.m0.cv1.bn`, `sppf.cv2`, `detect0`, ...), so that
`models/weights.flax_to_state_dict` carries JAX parameters across and
`models/yolo_weights` maps the official ultralytics names onto them.

Traps kept from the JAX model: BatchNorm eps 1e-3; symmetric padding k//2
(the 6x6 stem pads 2), not TF "SAME"; SPPF max pools 5x5 / stride 1
padded with -inf; nearest x2 upsampling.

The input is NCHW in [0, 1] (the port's layout); the heads come back NHWC,
[B, H_l, W_l, 3 * (5 + nc)], as the JAX model returns them, so that
`decode_predictions` / `decode_scored` read them in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# init_random is re-exported: the YOLO callers take it from this module
from human_body_proportion_estimation_tpu_torch.models.layers import (  # noqa: F401
    Conv2d,
    ConvBN,
    init_random,
    upsample_nearest,
)

# per-level anchor (w, h) pairs, P3/P4/P5 order
ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class YoloV5Config:
    depth_mult: float = 0.33
    width_mult: float = 0.50
    num_classes: int = 80

    def width(self, base: int) -> int:
        return int(math.ceil(base * self.width_mult / 8) * 8)

    def depth(self, base: int) -> int:
        return max(1, round(base * self.depth_mult))


YOLOV5S = YoloV5Config(0.33, 0.50)
YOLOV5M = YoloV5Config(0.67, 0.75)
YOLOV5L = YoloV5Config(1.0, 1.0)
VARIANTS = {"yolov5s": YOLOV5S, "yolov5m": YOLOV5M, "yolov5l": YOLOV5L}


class ConvBnSiLU(ConvBN):
    """Conv (symmetric padding (k-1)//2, which is ultralytics' k//2 for odd
    k and the stem's 2 for k = 6) + BatchNorm (eps 1e-3) + SiLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1):
        super().__init__(cin, cout, k, stride, act=F.silu, bn_eps=1e-3,
                         same=False)
        self.bn.momentum = 0.03     # flax momentum 0.97 (yolov5.py:78)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(cin, features, 1)
        self.cv2 = ConvBnSiLU(features, features, 3)
        self.add = shortcut and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return y + x if self.add else y


class C3(nn.Module):
    """CSP bottleneck stack with 3 convs; the bottlenecks are `m0`, `m1`,
    ... as in the flax tree."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c_ = features // 2
        self.cv1 = ConvBnSiLU(cin, c_, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut))
        self.cv2 = ConvBnSiLU(cin, c_, 1)
        self.cv3 = ConvBnSiLU(2 * c_, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max pools."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        c_ = features // 2
        self.cv1 = ConvBnSiLU(cin, c_, 1)
        self.cv2 = ConvBnSiLU(4 * c_, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        # max_pool2d pads with -inf, as flax `padding="SAME"` does
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], 1))


class YoloV5(nn.Module):
    """NCHW [B, 3, H, W] in [0, 1] -> 3 raw head tensors
    [B, H_l, W_l, 3 * (5 + nc)] f32, P3/P4/P5 order. The trunk computes in
    `dtype` (bf16 on the main path); the Detect convs in f32."""

    def __init__(self, config: YoloV5Config = YOLOV5M,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.config = cfg = config
        self.dtype = dtype
        w, d = cfg.width, cfg.depth
        self.stem = ConvBnSiLU(3, w(64), 6, 2)
        self.down1 = ConvBnSiLU(w(64), w(128), 3, 2)
        self.c3_1 = C3(w(128), w(128), d(3))
        self.down2 = ConvBnSiLU(w(128), w(256), 3, 2)
        self.c3_2 = C3(w(256), w(256), d(6))
        self.down3 = ConvBnSiLU(w(256), w(512), 3, 2)
        self.c3_3 = C3(w(512), w(512), d(9))
        self.down4 = ConvBnSiLU(w(512), w(1024), 3, 2)
        self.c3_4 = C3(w(1024), w(1024), d(3))
        self.sppf = SPPF(w(1024), w(1024))
        self.head_cv1 = ConvBnSiLU(w(1024), w(512), 1)
        self.head_c3_1 = C3(w(512) + w(512), w(512), d(3), shortcut=False)
        self.head_cv2 = ConvBnSiLU(w(512), w(256), 1)
        self.head_c3_2 = C3(w(256) + w(256), w(256), d(3), shortcut=False)
        self.head_cv3 = ConvBnSiLU(w(256), w(256), 3, 2)
        self.head_c3_3 = C3(w(256) + w(256), w(512), d(3), shortcut=False)
        self.head_cv4 = ConvBnSiLU(w(512), w(512), 3, 2)
        self.head_c3_4 = C3(w(512) + w(512), w(1024), d(3), shortcut=False)
        no = 3 * (5 + cfg.num_classes)
        for li, c in enumerate((w(256), w(512), w(1024))):
            self.add_module(f"detect{li}", Conv2d(c, no, 1, bias=True,
                                                  same=False))
        self.eval()     # flax's train=False default (layers.batch_norm)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.dtype)
        x = self.down1(self.stem(x))
        x = self.down2(self.c3_1(x))
        p3 = self.c3_2(x)
        p4 = self.c3_3(self.down3(p3))
        x = self.c3_4(self.down4(p4))
        p5 = self.sppf(x)

        # PANet top-down
        t5 = self.head_cv1(p5)
        h4 = self.head_c3_1(torch.cat([upsample_nearest(t5, 2), p4], 1))
        t4 = self.head_cv2(h4)
        out3 = self.head_c3_2(torch.cat([upsample_nearest(t4, 2), p3], 1))
        # bottom-up
        out4 = self.head_c3_3(torch.cat([self.head_cv3(out3), t4], 1))
        out5 = self.head_c3_4(torch.cat([self.head_cv4(out4), t5], 1))

        return [getattr(self, f"detect{li}")(feat.float()).permute(0, 2, 3, 1)
                for li, feat in enumerate((out3, out4, out5))]


def _grid(head: torch.Tensor, anchors) -> Tuple[torch.Tensor, ...]:
    b, h, w, _ = head.shape
    gx = torch.arange(w, dtype=torch.float32,
                      device=head.device)[None, None, :, None]
    gy = torch.arange(h, dtype=torch.float32,
                      device=head.device)[None, :, None, None]
    anc = torch.tensor(anchors, dtype=torch.float32, device=head.device)
    return gx, gy, anc


def _boxes(box: torch.Tensor, gx, gy, anc, stride: int) -> torch.Tensor:
    """Sigmoid box channels [..., 4] -> (cx, cy, w, h) pixels: xy =
    (2 s - 0.5 + grid) * stride, wh = (2 s)^2 * anchor."""
    xy = torch.stack([
        (box[..., 0] * 2.0 - 0.5 + gx) * stride,
        (box[..., 1] * 2.0 - 0.5 + gy) * stride,
    ], -1)
    wh = (box[..., 2:4] * 2.0) ** 2 * anc[None, None, None, :, :]
    return torch.cat([xy, wh], -1)


def decode_predictions(heads: List[torch.Tensor],
                       num_classes: int = 80) -> torch.Tensor:
    """Raw heads -> [B, sum(H_l * W_l * 3), 5 + nc] decoded predictions
    (reference raw-output decode, `obj_det_yolov5_onnx.py:144-166`), level
    order P3, P4, P5."""
    no = 5 + num_classes
    outs = []
    for head, stride, anchors in zip(heads, STRIDES, ANCHORS):
        b, h, w, _ = head.shape
        y = torch.sigmoid(head.reshape(b, h, w, len(anchors), no))
        gx, gy, anc = _grid(head, anchors)
        out = torch.cat([_boxes(y[..., :4], gx, gy, anc, stride),
                         y[..., 4:]], -1)
        outs.append(out.reshape(b, -1, no))
    return torch.cat(outs, 1)


def decode_scored(
    heads: List[torch.Tensor], num_classes: int = 80
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw heads -> (boxes_xywh [B, N, 4], obj [B, N], best_cls [B, N]
    int32, best_logit [B, N]): the class argmax / max taken on the LOGITS,
    before any sigmoid (sigmoid is monotone and the objectness factor is
    common and positive, so `ops/nms.yolo_nms_scored` selects what
    `yolo_nms` selects from `decode_predictions`); the [N, 85] sigmoid
    tensor is never made."""
    no = 5 + num_classes
    boxes, objs, best_cs, best_ls = [], [], [], []
    for head, stride, anchors in zip(heads, STRIDES, ANCHORS):
        b, h, w, _ = head.shape
        y = head.reshape(b, h, w, len(anchors), no)
        gx, gy, anc = _grid(head, anchors)
        box = _boxes(torch.sigmoid(y[..., :4]), gx, gy, anc, stride)
        cls_logits = y[..., 5:]
        boxes.append(box.reshape(b, -1, 4))
        objs.append(torch.sigmoid(y[..., 4]).reshape(b, -1))
        best_cs.append(cls_logits.argmax(-1).to(torch.int32).reshape(b, -1))
        best_ls.append(cls_logits.amax(-1).reshape(b, -1))
    return (torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(best_cs, 1),
            torch.cat(best_ls, 1))
